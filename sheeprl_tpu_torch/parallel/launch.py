"""The process world of data-parallel training: one process a device
(counterpart of ``sheeprl_tpu/fabric.py``'s ``init_distributed`` and of its
launch, ``:84-128`` and ``:329-353``).

The JAX package drives every device from one process through a mesh; the
port runs one process a device, PyTorch's idiom and the reference
SheepRL's, with an explicit all-reduce of the gradients
(:mod:`sheeprl_tpu_torch.obs.dist.comms`).

- :func:`launch_local` is how ``Fabric.launch`` runs an entrypoint on N
  local devices: the calling process becomes rank 0, ranks 1..N-1 are
  spawned (a fresh interpreter each), and all of them meet at a rendezvous
  on a free local port (``tcp://127.0.0.1:<port>``). Rank ``r`` owns
  ``cuda:r`` with NCCL, or the CPU with gloo. Rank 0's result is returned;
  rank 0's exception is raised as it is (the other ranks' tracebacks in a
  note), and a rank that fails alone makes the launch raise with its
  traceback.
- :func:`join_external` joins a world another launcher started
  (``torchrun``, or by hand for ``fabric.num_nodes>1``) through
  ``env://``: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
  ``MASTER_PORT``.
- :func:`spawn` is the explicit launcher for tests and ``chip_smoke.py``:
  ``spawn(fn, world_size, backend, device_of_rank)`` runs
  ``fn(fabric, *args)`` in ``world_size`` fresh processes and returns each
  rank's result. Only it may place two ranks on one card (gloo ranks
  sharing a card; NCCL refuses two ranks on one device).

A process belongs to at most one world; :func:`current_world` is it (None
outside one). The NCCL communicator is made by one eager collective right
after the rendezvous, so that a captured step's collectives find it built.
"""

from __future__ import annotations

import os
import pickle
import socket
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable, List, Optional, Sequence, Union

import torch

__all__ = [
    "World",
    "current_world",
    "free_port",
    "init_world",
    "join_external",
    "launch_local",
    "shutdown_world",
    "spawn",
]

#: seconds a collective (and the rendezvous) may wait for a peer before it fails
TIMEOUT_S = 600

_WORLD: Optional["World"] = None


@dataclass(frozen=True)
class World:
    """This process's place in the world: ``backend`` is ``nccl`` or
    ``gloo``, ``device`` the device the rank computes on."""

    world_size: int
    global_rank: int
    local_rank: int
    node_rank: int
    backend: str
    device: torch.device

    @property
    def capturable(self) -> bool:
        """Whether a step's collectives can be captured in a CUDA graph:
        NCCL's can, gloo's (host collectives) cannot."""
        return self.backend == "nccl"


def current_world() -> Optional[World]:
    """The world this process belongs to, or None."""
    return _WORLD


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return int(s.getsockname()[1])


def init_world(
    *,
    backend: str,
    init_method: str,
    rank: int,
    world_size: int,
    device: Union[str, torch.device],
    local_rank: Optional[int] = None,
    node_rank: int = 0,
) -> World:
    """Join the process group and make it this process's world. With NCCL
    the rank's card becomes the current device and one eager all-reduce
    builds the communicator."""
    import torch.distributed as dist

    global _WORLD
    if _WORLD is not None:
        raise RuntimeError("this process already belongs to a world")
    device = torch.device(device)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend={backend!r}: expected 'nccl' or 'gloo'")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the NCCL backend needs a CUDA device a rank")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kwargs = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, world_size=int(world_size), rank=int(rank),
                            timeout=timedelta(seconds=TIMEOUT_S), **kwargs)
    _WORLD = World(int(world_size), int(rank), int(rank if local_rank is None else local_rank), int(node_rank),
                   backend, device)
    if backend == "nccl":
        from sheeprl_tpu_torch.obs.dist import comms

        comms.warm_up(device)
    return _WORLD


def shutdown_world() -> None:
    """Leave the world (destroy the process group); a no-op outside one."""
    import torch.distributed as dist

    global _WORLD
    if _WORLD is None:
        return
    _WORLD = None
    if dist.is_initialized():
        dist.destroy_process_group()


def join_external(accelerator: str) -> World:
    """Join the world of an external launcher through ``env://``; the rank's
    device is ``cuda:<LOCAL_RANK>`` with NCCL, or the CPU with gloo."""
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        if key not in os.environ:
            raise RuntimeError(f"an external launch sets {key} (torchrun does); it is missing")
    rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    node_rank = int(os.environ.get("GROUP_RANK", os.environ.get("NODE_RANK", 0)))
    if accelerator == "cuda":
        backend, device = "nccl", torch.device("cuda", local_rank)
    else:
        backend, device = "gloo", torch.device("cpu")
    return init_world(backend=backend, init_method="env://", rank=rank, world_size=world_size, device=device,
                      local_rank=local_rank, node_rank=node_rank)


def _rank_main(rank: int, world_size: int, init_method: str, backend: str, device: str, make_fabric: Callable,
               fabric_kwargs: dict, fn: Callable, args: tuple, kwargs: dict, results, errors) -> None:
    """A spawned rank: join the world, build its Fabric, run ``fn``, leave."""
    try:
        init_world(backend=backend, init_method=init_method, rank=rank, world_size=world_size, device=device)
        fabric = make_fabric(**fabric_kwargs)
        out = fn(fabric, *args, **kwargs)
        if results is not None:
            # pickled by value: multiprocessing's pickler would share a tensor's storage through a file descriptor
            # that dies with this process
            results.put((rank, pickle.dumps(out)))
    except BaseException:
        errors.put((rank, traceback.format_exc()))
        raise SystemExit(1)
    finally:
        shutdown_world()


def _start(ranks: Sequence[int], world_size: int, init_method: str, backend: str, devices: Sequence[str],
           make_fabric: Callable, fabric_kwargs: dict, fn: Callable, args: tuple, kwargs: dict, results, errors,
           ctx) -> List[Any]:
    procs = []
    for r in ranks:
        p = ctx.Process(
            target=_rank_main, name=f"rank{r}",
            args=(r, world_size, init_method, backend, str(devices[r]), make_fabric, fabric_kwargs, fn, args, kwargs,
                  results, errors),
        )
        p.start()
        procs.append(p)
    return procs


def _drain_errors(errors) -> List[tuple]:
    out = []
    while not errors.empty():
        out.append(errors.get())
    return sorted(out)


def _stop(procs, timeout: float) -> None:
    for p in procs:
        p.join(timeout)
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(10.0)


def launch_local(fn: Callable, args: tuple, kwargs: dict, *, world_size: int, backend: str,
                 devices: Sequence[str], make_fabric: Callable, fabric_kwargs: dict) -> Any:
    """Run ``fn(fabric, *args, **kwargs)`` on ``world_size`` local ranks:
    this process as rank 0 (its Fabric made by ``make_fabric(**fabric_kwargs)``
    inside the world), the others spawned. Returns rank 0's result; raises
    if any rank failed."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    errors = ctx.SimpleQueue()
    init_method = f"tcp://127.0.0.1:{free_port()}"
    procs = _start(range(1, world_size), world_size, init_method, backend, devices, make_fabric, fabric_kwargs, fn,
                   args, kwargs, None, errors, ctx)
    failed: Optional[BaseException] = None
    result = None
    try:
        init_world(backend=backend, init_method=init_method, rank=0, world_size=world_size, device=devices[0])
        result = fn(make_fabric(**fabric_kwargs), *args, **kwargs)
    except BaseException as err:  # noqa: BLE001  (re-raised below, the peers' tracebacks attached)
        failed = err
    finally:
        shutdown_world()
        _stop(procs, TIMEOUT_S if failed is None else 30.0)
    peers = _drain_errors(errors)
    detail = "".join(f"\n--- rank {r} ---\n{tb}" for r, tb in peers)
    if failed is not None:
        if detail:
            failed.add_note(f"the other ranks:{detail}")
        raise failed
    bad = [p.name for p in procs if p.exitcode not in (0, None)]
    if peers or bad:
        raise RuntimeError(f"data-parallel run failed on {bad}{detail}")
    return result


def spawn(fn: Callable, world_size: int, backend: str = "gloo",
          device_of_rank: Union[str, Sequence[str]] = "cpu", args: tuple = (), kwargs: Optional[dict] = None,
          fabric_kwargs: Optional[dict] = None, timeout: float = TIMEOUT_S) -> List[Any]:
    """Run ``fn(fabric, *args, **kwargs)`` on ``world_size`` fresh processes
    and return their results in rank order (each must pickle). ``fn`` is a
    module-level function; ``device_of_rank`` one device for every rank
    (gloo ranks may share a card) or one a rank. The ranks' Fabric is
    ``Fabric(**fabric_kwargs)`` in the world, on its rank's device."""
    import multiprocessing as mp

    from sheeprl_tpu_torch.fabric import Fabric

    devices = [device_of_rank] * world_size if isinstance(device_of_rank, str) else list(device_of_rank)
    if len(devices) != world_size:
        raise ValueError(f"device_of_rank names {len(devices)} devices for {world_size} ranks")
    if backend == "nccl" and len(set(devices)) != len(devices):
        raise ValueError("NCCL refuses two ranks on one device: give each rank its own card, or use gloo")
    ctx = mp.get_context("spawn")
    results, errors = ctx.SimpleQueue(), ctx.SimpleQueue()
    fabric_kwargs = dict(fabric_kwargs or {})
    fabric_kwargs.setdefault("devices", world_size)
    procs = _start(range(world_size), world_size, f"tcp://127.0.0.1:{free_port()}", backend, devices, Fabric,
                   fabric_kwargs, fn, tuple(args), dict(kwargs or {}), results, errors, ctx)
    out: dict = {}
    deadline = time.monotonic() + float(timeout)
    try:
        while (len(out) < world_size and not any(p.exitcode not in (0, None) for p in procs)
               and time.monotonic() < deadline):
            for p in procs:
                p.join(0.05)
            while not results.empty():
                rank, value = results.get()
                out[rank] = pickle.loads(value)
    finally:
        _stop(procs, timeout)
    while not results.empty():
        rank, value = results.get()
        out[rank] = pickle.loads(value)
    peers = _drain_errors(errors)
    if peers or len(out) != world_size:
        detail = "".join(f"\n--- rank {r} ---\n{tb}" for r, tb in peers)
        raise RuntimeError(f"spawned ranks failed: {[p.exitcode for p in procs]}{detail}")
    return [out[r] for r in range(world_size)]

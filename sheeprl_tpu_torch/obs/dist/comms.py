"""Measured collective communication, and the one place every collective of
the port is spelled (counterpart of ``sheeprl_tpu/obs/dist/comms.py``).

Two layers, as in the JAX package:

- **Host-level collectives** (the Fabric's ``barrier``, ``all_gather``,
  ``broadcast`` and ``all_reduce``: :func:`host_barrier`,
  :func:`host_all_gather`, :func:`host_broadcast`,
  :func:`host_all_reduce`): :func:`collective_span` wraps each call in a
  ``Time/comms_<kind>_time`` span and counts its payload bytes, wall
  milliseconds and achieved GB/s into the run counters (``comms_ops``,
  ``comms_bytes``, ``comms_ms`` and the per-kind ``comms`` breakdown of
  ``telemetry.json``).
- **In-step collectives** (:func:`pmean_`, :func:`pmean`, :func:`psum`,
  :func:`all_gather`): the gradient sync every data-parallel train step
  runs, the metrics' mean and DreamerV3's ``Moments`` gather. They are the
  chokepoint every algorithm routes its syncs through
  (``tests/test_torch_lint_telemetry.py`` holds that no other module of the
  port calls ``torch.distributed``'s collectives). Each optimizer's
  gradients are flattened into one bucket a dtype, so a sync is one
  collective a group, not one a tensor. With NCCL they run inside the
  step's CUDA graph, and their device time is the trace parser's
  (``obs/prof/trace.py``: NCCL's kernels in ``comms_ms_total`` and
  ``comms_ms_by_kind``); gloo's are host collectives (a step with them
  runs eagerly, ``train/graphs.py``) and are counted through
  :func:`collective_span`.

Outside a world (:func:`sheeprl_tpu_torch.parallel.current_world` is None)
every function here is the identity over one participant: no collective and
no copy. A world of one rank still issues its collectives: that is the DDP
path on one card.

Wire-byte accounting uses the ring factors, so the reported GB/s is what a
link carried: all-reduce moves ``2(n-1)/n × payload`` a participant,
all-gather and broadcast ``(n-1)/n`` of the gathered or broadcast bytes, a
barrier nothing.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

__all__ = [
    "KINDS",
    "LINK_PEAKS_GBPS",
    "all_gather",
    "broadcast_",
    "collective_span",
    "host_all_gather",
    "host_all_reduce",
    "host_barrier",
    "host_broadcast",
    "link_peak_gbps",
    "pmean",
    "pmean_",
    "psum",
    "record_collective",
    "warm_up",
    "wire_bytes",
    "world_size",
]

#: collective kinds the counters break down by
KINDS = ("all_reduce", "all_gather", "broadcast", "barrier")

#: an H100's device-link peaks, GB/s one direction: NVLink 4 (18 links, 900 GB/s both directions) on the SXM card
#: and PCIe Gen5 x16 (128 GB/s both directions) on the PCIe card (NVIDIA H100 Tensor Core GPU datasheet)
LINK_PEAKS_GBPS = {"nvlink4": 450.0, "pcie5": 64.0}


def _world():
    from sheeprl_tpu_torch.parallel.launch import current_world

    return current_world()


def world_size() -> int:
    """The number of ranks of this process's world (1 outside one)."""
    world = _world()
    return 1 if world is None else world.world_size


def wire_bytes(kind: str, payload_bytes: int, n: int) -> int:
    """Bytes a ring implementation moves a participant for ``payload``:
    2(n-1)/n for an all-reduce, (n-1)/n for an all-gather or a pipelined
    broadcast, 0 for a barrier; nothing crosses a link with ``n <= 1``."""
    if n <= 1 or payload_bytes <= 0:
        return 0
    if kind == "all_reduce":
        return int(payload_bytes * 2 * (n - 1) / n)
    if kind in ("all_gather", "broadcast"):
        return int(payload_bytes * (n - 1) / n)
    return 0


def record_collective(kind: str, payload_bytes: int, seconds: float, world: int = 1) -> Optional[float]:
    """Record one completed collective into the run counters. Returns the
    achieved wire GB/s (None when nothing crossed a link or the clock did
    not advance). A no-op with the telemetry off."""
    from sheeprl_tpu_torch.obs import counters as _counters

    c = _counters.installed()
    if c is None:
        return None
    wire = wire_bytes(kind, payload_bytes, world)
    gbps = (wire / seconds / 1e9) if (wire and seconds > 0) else None
    c.add_comms(kind, payload_bytes, seconds * 1e3, gbps)
    return gbps


@contextmanager
def collective_span(kind: str, payload_bytes: int = 0, world: Optional[int] = None):
    """Span and counter accounting around one collective the host waits for
    (``Time/comms_<kind>_time``, phase ``comms``). ``world`` defaults to the
    size of this process's world."""
    from sheeprl_tpu_torch.obs.spans import span

    if world is None:
        world = world_size()
    t0 = time.perf_counter()
    with span(f"Time/comms_{kind}_time", phase="comms"):
        yield
    record_collective(kind, int(payload_bytes), time.perf_counter() - t0, world)


def link_peak_gbps(device_name: Optional[str] = None) -> Optional[float]:
    """The device link's peak GB/s one direction: the PCIe figure for a card
    whose name says PCIe, NVLink 4's for any other H100-class card, None off
    the card (the CPU's gloo loopback has no registered peak)."""
    if device_name is None:
        if not torch.cuda.is_available():
            return None
        device_name = torch.cuda.get_device_name(0)
    if "pcie" in device_name.lower():
        return LINK_PEAKS_GBPS["pcie5"]
    return LINK_PEAKS_GBPS["nvlink4"]


def warm_up(device) -> None:
    """One eager all-reduce on ``device``: builds the NCCL communicator
    before any step is captured."""
    import torch.distributed as dist

    probe = torch.zeros(1, device=device)
    dist.all_reduce(probe)
    if probe.is_cuda:
        torch.cuda.synchronize(probe.device)


# -- in-step collectives -------------------------------------------------------


def _host_timed(world) -> bool:
    """gloo's collectives block the host: they are timed by a span. NCCL's
    run on the device (inside a graph or queued on the stream) and are the
    trace's."""
    return world.backend == "gloo"


def _all_reduce(flat: torch.Tensor, world, mean: bool = False) -> None:
    """``flat`` summed (or with ``mean`` averaged) over the world, in place.
    NCCL averages in its own kernel (``ReduceOp.AVG``: each contribution
    scaled by 1/n, then summed; a world of one rank runs it as one
    ``oneRankReduce`` kernel, an in-place sum there being no work at all);
    gloo, which has no average, sums and divides."""
    import torch.distributed as dist

    if _host_timed(world):
        with collective_span("all_reduce", flat.numel() * flat.element_size(), world.world_size):
            dist.all_reduce(flat)
    elif mean:
        dist.all_reduce(flat, op=dist.ReduceOp.AVG)
        return
    else:
        dist.all_reduce(flat)
    if mean:
        flat.div_(world.world_size)


def _reduce_bucketed(tensors: Sequence[torch.Tensor], mean: bool, in_place: bool) -> List[torch.Tensor]:
    """All-reduce ``tensors`` as one flat bucket a dtype (the sum, or the
    mean with ``mean``); ``in_place`` writes the result back into them, else
    returns new tensors (views of the bucket)."""
    world = _world()
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        parts = [tensors[i] for i in idx]
        flat = torch.cat([t.reshape(-1) for t in parts])
        _all_reduce(flat, world, mean)
        for i, t, chunk in zip(idx, parts, flat.split([p.numel() for p in parts])):
            if in_place:
                t.copy_(chunk.view_as(t))
                out[i] = t
            else:
                out[i] = chunk.view_as(t)
    return out  # type: ignore[return-value]


def pmean_(tensors: Sequence[torch.Tensor]) -> None:
    """Mean-all-reduce ``tensors`` (one optimizer's gradients) in place, one
    collective a dtype. The identity outside a world."""
    tensors = [t for t in tensors if t is not None]
    if _world() is None or not tensors:
        return
    _reduce_bucketed(tensors, mean=True, in_place=True)


def _tree_reduce(tree: Any, mean: bool) -> Any:
    if _world() is None:
        return tree
    if isinstance(tree, torch.Tensor):
        return _reduce_bucketed([tree], mean, in_place=False)[0]
    if isinstance(tree, dict):
        keys = list(tree)
        return dict(zip(keys, _reduce_bucketed([tree[k] for k in keys], mean, in_place=False)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_reduce_bucketed(list(tree), mean, in_place=False))
    raise TypeError(f"pmean/psum take a tensor, a list or a dict of tensors, got {type(tree).__name__}")


def pmean(tree: Any) -> Any:
    """The mean over the world of a tensor, a list or a dict of tensors (the
    step's metrics), one collective a dtype; new tensors. The identity (the
    same objects) outside a world."""
    return _tree_reduce(tree, mean=True)


def psum(tree: Any) -> Any:
    """The sum over the world, as :func:`pmean`."""
    return _tree_reduce(tree, mean=False)


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """``[world, *x.shape]``: every rank's ``x`` in rank order (DreamerV3's
    ``Moments`` gather). Outside a world ``x[None]``, a view. gloo gathers
    only host tensors: a card tensor on gloo is gathered as the sum of
    zero-padded rows (exact: each row has one non-zero addend)."""
    world = _world()
    if world is None:
        return x[None]
    import torch.distributed as dist

    x = x.contiguous()
    n = world.world_size
    if world.backend == "nccl":
        out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x)
        return out
    if x.is_cuda:
        out = torch.zeros((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
        out[world.global_rank].copy_(x)
        _all_reduce(out.view(-1), world)
        return out
    out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    with collective_span("all_gather", out.numel() * out.element_size(), n):
        dist.all_gather(list(out.unbind(0)), x)
    return out


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Rank ``src``'s values of ``tensors``, written into every rank's in
    place, one collective a dtype (the starting weights). The identity
    outside a world."""
    world = _world()
    tensors = [t for t in tensors if t is not None]
    if world is None or not tensors:
        return
    import torch.distributed as dist

    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for parts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in parts])
            with collective_span("broadcast", flat.numel() * flat.element_size(), world.world_size):
                dist.broadcast(flat, src=int(src))
            for t, chunk in zip(parts, flat.split([p.numel() for p in parts])):
                t.copy_(chunk.view_as(t))


# -- host-level collectives (the Fabric's) -------------------------------------


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _host(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _nbytes(tree: Any) -> int:
    return int(sum(_host(leaf).nbytes for leaf in _leaves(tree)))


def _wire_tensor(a: np.ndarray, world) -> torch.Tensor:
    """A copy of a host array as a tensor the world's backend moves (NCCL:
    on the rank's card; bool as uint8): the collectives write into it, never
    into the caller's array."""
    t = torch.from_numpy(np.array(a.astype(np.uint8) if a.dtype == np.bool_ else a, order="C", copy=True))
    return t.to(world.device) if world.backend == "nccl" else t


def _from_wire(t: torch.Tensor, dtype) -> np.ndarray:
    out = t.cpu().numpy()
    return out.astype(np.bool_) if dtype == np.bool_ else out


def host_barrier() -> None:
    """Every rank waits for every other (a no-op outside a world)."""
    world = _world()
    if world is None:
        return
    import torch.distributed as dist

    with collective_span("barrier", 0, world.world_size):
        if world.backend == "nccl":
            dist.barrier(device_ids=[world.device.index])
        else:
            dist.barrier()


def host_all_gather(tree: Any) -> Any:
    """Each leaf (a numpy array, a number or a tensor) gathered from every
    rank into a numpy array with a new leading rank axis; outside a world
    the axis has size 1."""
    world = _world()
    if world is None:
        return _map(tree, lambda x: _host(x)[None])
    import torch.distributed as dist

    n = world.world_size
    tree = _map(tree, _host)

    def gather(a: np.ndarray) -> np.ndarray:
        t = _wire_tensor(a, world)
        out = torch.empty((n,) + tuple(t.shape), dtype=t.dtype, device=t.device)
        if world.backend == "nccl":
            dist.all_gather_into_tensor(out, t)
        else:
            dist.all_gather(list(out.unbind(0)), t)
        return _from_wire(out, a.dtype)

    with collective_span("all_gather", _nbytes(tree) * n, n):
        return _map(tree, gather)


def host_broadcast(tree: Any, src: int = 0) -> Any:
    """Rank ``src``'s tree on every rank (numpy leaves); the tree itself
    outside a world. Every rank passes a tree of the same shapes."""
    world = _world()
    if world is None:
        return tree
    import torch.distributed as dist

    tree = _map(tree, _host)

    def bcast(a: np.ndarray) -> np.ndarray:
        t = _wire_tensor(a, world)
        dist.broadcast(t, src=int(src))
        return _from_wire(t, a.dtype)

    with collective_span("broadcast", _nbytes(tree), world.world_size):
        return _map(tree, bcast)


def host_all_reduce(tree: Any, op: str = "sum") -> Any:
    """The sum (or mean) over the ranks of a tree of numbers; leaves come
    back as numpy arrays, a non-float leaf as float32 (the JAX Fabric's
    cast). Outside a world each leaf as a numpy array."""
    if op not in ("sum", "mean"):
        raise ValueError(f"fabric.all_reduce supports op='sum'|'mean', got {op!r}")
    world = _world()
    if world is None:
        return _map(tree, _host)
    import torch.distributed as dist

    def as_float(x: Any) -> np.ndarray:
        a = _host(x)
        return a if a.dtype.kind == "f" else a.astype(np.float32)

    tree = _map(tree, as_float)

    def reduce(a: np.ndarray) -> np.ndarray:
        t = _wire_tensor(a, world)
        dist.all_reduce(t)
        if op == "mean":
            t = t / np.float32(world.world_size)
        return t.cpu().numpy().astype(a.dtype)

    with collective_span("all_reduce", _nbytes(tree), world.world_size):
        return _map(tree, reduce)

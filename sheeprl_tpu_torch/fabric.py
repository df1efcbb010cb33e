"""The runtime handed to every entrypoint as ``fabric`` (counterpart of
``sheeprl_tpu/fabric.py``): the device, the world of data-parallel ranks,
their collectives, precision, seeds and checkpoint I/O.

One process drives one device: ``cuda`` unless the config asks for
``accelerator=cpu``; ``auto`` means ``cuda`` and raises without a card.
``devices`` is the number of devices to train on (``auto`` is one, the
decoupled entrypoints' learner). With more than one, :meth:`Fabric.launch`
trains data-parallel over processes, one a device
(:mod:`sheeprl_tpu_torch.parallel`): this process becomes rank 0, the
other ranks are spawned, rank ``r`` owns ``cuda:r`` with NCCL, or the CPU
with gloo; a run started by ``torchrun`` (or by hand, as
``fabric.num_nodes>1`` needs) joins its world through ``env://`` instead
of spawning. Asking for more cards than the machine has raises; nothing
places two ranks on one card (only ``parallel.spawn``, the tests' launcher,
may share a card between gloo ranks).

The world: ``world_size`` (the ranks), ``global_rank``, ``local_rank``,
``node_rank``, ``is_global_zero`` and ``data_parallel_size`` (the
gradient-mean world, ``world_size``: parameter sharding,
``parallel.model_axis``, is ROADMAP queue A item 7c). The JAX package's
accounting holds: each rank steps ``env.num_envs`` envs and samples
``per_rank_batch_size`` rows, ``world_size`` times what one rank does
being the JAX run's. The collectives (:meth:`barrier`, :meth:`all_gather`,
:meth:`broadcast`, :meth:`all_reduce`) take trees of numpy arrays, numbers
and tensors and return numpy leaves, with the JAX Fabric's semantics; they
run through :mod:`sheeprl_tpu_torch.obs.dist.comms`, measured.
:meth:`sync_modules` has rank 0 broadcast the starting weights once.
Every ``strategy`` (``auto``, ``single_device``, ``ddp``, ``dp``,
``fsdp``) trains data-parallel: the JAX package maps each onto its mesh
and has no FSDP of its own.

Randomness is explicit: :meth:`Fabric.seed_everything` returns a
``torch.Generator`` on the device and a numpy ``Generator`` seeded with the
rank's seed (:meth:`rank_seed`: the run's seed on rank 0, a seed of its own
on every other rank, as the JAX step folds the rank into its key), and
nothing reads a global seed. Checkpoints go through ``fabric.call`` into
the :mod:`sheeprl_tpu_torch.ckpt` subsystem (rank 0 writes the model, each
rank its replay buffer) and come back through :meth:`Fabric.load`.

Precision is ``32-true`` or ``bf16-mixed``, with the JAX package's meaning:
parameters stay f32 (:attr:`Fabric.param_dtype`) and the modules that take
a ``dtype`` compute their activations in :attr:`Fabric.compute_dtype` (None
for f32).
"""

from __future__ import annotations

import os
import random
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.device import resolve_device

__all__ = ["Fabric", "compute_dtype_from_precision"]

_ACCELERATORS = {"auto": None, "cuda": "cuda", "gpu": "cuda", "cpu": "cpu"}


def compute_dtype_from_precision(precision: Any) -> Optional[torch.dtype]:
    """The one precision → compute-dtype mapping (shared by Fabric and the
    model builders): ``32-true`` → None (f32 everywhere), ``bf16-mixed`` →
    bf16 activations with f32 parameters and losses. Anything else raises."""
    p = str(precision or "32-true").lower()
    if p in ("32-true", "32"):
        return None
    if p == "bf16-mixed":
        return torch.bfloat16
    raise ValueError(f"Unsupported fabric.precision {precision!r}: use '32-true' or 'bf16-mixed'")


_STRATEGIES = ("auto", "single_device", "ddp", "dp", "fsdp")


def _device_count(devices: Any) -> int:
    if devices is None or str(devices) in ("auto", "-1"):
        return 1
    if isinstance(devices, (list, tuple)):
        raise ValueError(f"fabric.devices={devices}: give the number of devices, not a list")
    n = int(devices)
    if n < 1:
        raise ValueError(f"fabric.devices={devices}: expected a positive count or 'auto'")
    return n


def _external_launch() -> bool:
    """An external launcher (``torchrun``) started this process."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


class Fabric:
    """One process, one device; with ``devices>1`` one rank of a world."""

    def __init__(
        self,
        devices: Any = 1,
        num_nodes: int = 1,
        strategy: str = "auto",
        accelerator: str = "auto",
        precision: str = "32-true",
        callbacks: Optional[Sequence[Any]] = None,
        prng_impl: Optional[str] = None,
    ):
        from sheeprl_tpu_torch.parallel import current_world

        accelerator = str(accelerator or "auto").lower()
        if accelerator not in _ACCELERATORS:
            raise ValueError(f"fabric.accelerator={accelerator!r}: expected one of {sorted(_ACCELERATORS)}")
        self.strategy = str(strategy or "auto").lower()
        if self.strategy not in _STRATEGIES:
            raise ValueError(f"fabric.strategy={strategy}: expected one of {_STRATEGIES}")
        compute_dtype_from_precision(precision)  # raises on any other precision
        self.precision = str(precision or "32-true")
        self.num_nodes = int(num_nodes)
        self._devices = _device_count(devices)
        # prng_impl selects the JAX package's key implementation; torch has one generator kind
        self._init_kwargs = dict(devices=devices, num_nodes=num_nodes, strategy=strategy, accelerator=accelerator,
                                 precision=precision, callbacks=callbacks)
        self.callbacks = list(callbacks or [])
        self._world = current_world()
        if self._world is not None:
            self.device = self._world.device
            return
        if self.num_nodes > 1 and not _external_launch():
            raise ValueError(
                f"fabric.num_nodes={num_nodes}: a multi-node run is started by an external launcher (torchrun, which "
                "sets RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT); each node's process joins through env://"
            )
        self.device = resolve_device(_ACCELERATORS[accelerator])
        if self.device.type == "cuda" and self._devices > torch.cuda.device_count():
            raise ValueError(
                f"Requested {self._devices} devices but only {torch.cuda.device_count()} are available "
                "(the port places one rank on a card)"
            )

    # -- topology -------------------------------------------------------------

    @property
    def world_size(self) -> int:
        """The number of ranks (the reference's DDP world): the devices asked
        for, on every node."""
        return self._world.world_size if self._world is not None else self._devices * self.num_nodes

    @property
    def global_rank(self) -> int:
        return self._world.global_rank if self._world is not None else 0

    @property
    def local_rank(self) -> int:
        return self._world.local_rank if self._world is not None else 0

    @property
    def node_rank(self) -> int:
        return self._world.node_rank if self._world is not None else 0

    @property
    def is_global_zero(self) -> bool:
        return self.global_rank == 0

    @property
    def data_parallel_size(self) -> int:
        """The gradient-mean world: ``world_size``."""
        return self.world_size

    @property
    def is_distributed(self) -> bool:
        """Whether this Fabric is a rank of a world (its steps all-reduce)."""
        return self._world is not None

    @property
    def backend(self) -> Optional[str]:
        """``nccl`` or ``gloo`` inside a world, None outside one."""
        return None if self._world is None else self._world.backend

    def launch(self, fn: Callable, *args: Any, **kwargs: Any) -> Any:
        """Run ``fn(fabric, *args, **kwargs)``: here with one device (or as a
        rank of the world this process belongs to); else on every rank of a
        new world (spawned locally, or joined from an external launch),
        returning rank 0's result."""
        from sheeprl_tpu_torch.parallel import join_external, launch_local, shutdown_world

        if self._world is not None or self.world_size == 1:
            return fn(self, *args, **kwargs)
        if _external_launch():
            join_external(self.device.type)
            try:
                return fn(Fabric(**self._init_kwargs), *args, **kwargs)
            finally:
                shutdown_world()
        n = self._devices
        if self.device.type == "cuda":
            backend, devices = "nccl", [f"cuda:{i}" for i in range(n)]
        else:
            backend, devices = "gloo", ["cpu"] * n
        return launch_local(fn, args, kwargs, world_size=n, backend=backend, devices=devices, make_fabric=Fabric,
                            fabric_kwargs=self._init_kwargs)

    def print(self, *args: Any, **kwargs: Any) -> None:
        if self.is_global_zero:
            print(*args, **kwargs)

    # -- collectives ------------------------------------------------------------

    def barrier(self, name: str = "") -> None:
        """Every rank waits for every other (a no-op outside a world)."""
        from sheeprl_tpu_torch.obs.dist import comms

        del name
        comms.host_barrier()

    def all_gather(self, tree: Any) -> Any:
        """A tree gathered from every rank: numpy leaves with a new leading
        rank axis (size 1 outside a world)."""
        from sheeprl_tpu_torch.obs.dist import comms

        return comms.host_all_gather(tree)

    def broadcast(self, tree: Any, src: int = 0) -> Any:
        """Rank ``src``'s tree on every rank; the tree itself outside a world."""
        from sheeprl_tpu_torch.obs.dist import comms

        return comms.host_broadcast(tree, src)

    def all_reduce(self, tree: Any, op: str = "sum") -> Any:
        """The sum (or mean) of a float tree over the ranks, as numpy leaves."""
        from sheeprl_tpu_torch.obs.dist import comms

        return comms.host_all_reduce(tree, op)

    def sync_modules(self, *modules: torch.nn.Module) -> None:
        """Rank 0's parameters and buffers, broadcast once into every rank's
        modules in place (the starting weights; a no-op outside a world)."""
        from sheeprl_tpu_torch.obs.dist import comms

        comms.broadcast_([t for m in modules for t in (*m.parameters(), *m.buffers())], src=0)

    # -- precision ------------------------------------------------------------

    @property
    def compute_dtype(self) -> Optional[torch.dtype]:
        """None for f32, bf16 under ``bf16-mixed``: parameters stay f32."""
        return compute_dtype_from_precision(self.precision)

    @property
    def param_dtype(self) -> torch.dtype:
        return torch.float32

    # -- randomness -----------------------------------------------------------

    def rank_seed(self, seed: int) -> int:
        """This rank's seed: ``seed`` on rank 0, one of its own (from
        ``(seed, rank)``) on every other rank."""
        if self.global_rank == 0:
            return int(seed)
        return int(np.random.SeedSequence([int(seed), self.global_rank]).generate_state(1, np.uint32)[0])

    def seed_everything(self, seed: int) -> Tuple[torch.Generator, np.random.Generator]:
        """Seed Python's ``random`` and return ``(torch generator on the
        device, numpy generator)``, both from this rank's seed
        (:meth:`rank_seed`); the global torch and numpy streams are left
        alone."""
        seed = self.rank_seed(seed)
        random.seed(seed)
        return torch.Generator(device=self.device).manual_seed(seed), np.random.default_rng(seed)

    # -- checkpoints and callbacks -------------------------------------------

    def call(self, hook_name: str, **kwargs: Any) -> None:
        for cb in self.callbacks:
            hook = getattr(cb, hook_name, None)
            if callable(hook):
                hook(fabric=self, **kwargs)

    def save(self, path: str, state: Dict[str, Any]) -> None:
        """Write ``state`` as a manifest checkpoint at ``path``, synchronously."""
        from sheeprl_tpu_torch.ckpt.manager import CheckpointManager

        CheckpointManager(async_save=False).save(path, state, fabric=self)

    def load(self, path: str) -> Dict[str, Any]:
        """Read a manifest checkpoint (every array checksummed) into a tree
        of numpy arrays; the caller moves what it needs to the device."""
        from sheeprl_tpu_torch.ckpt.resume import read_checkpoint

        return read_checkpoint(path, rank=self.global_rank)

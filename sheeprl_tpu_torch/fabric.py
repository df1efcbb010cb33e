"""The single-device runtime handed to every entrypoint as ``fabric``
(counterpart of ``sheeprl_tpu/fabric.py``).

One process drives one device: ``cuda`` unless the config asks for
``accelerator=cpu``; ``auto`` means ``cuda`` and raises without a card.
Randomness is explicit: :meth:`Fabric.seed_everything` returns a
``torch.Generator`` on the device and a numpy ``Generator``, and nothing
reads a global seed. Checkpoints go through ``fabric.call`` into the
:mod:`sheeprl_tpu_torch.ckpt` subsystem and come back through
:meth:`Fabric.load`.

Precision is ``32-true`` or ``bf16-mixed``, with the JAX package's meaning:
parameters stay f32 (:attr:`Fabric.param_dtype`) and the modules that take
a ``dtype`` compute their activations in :attr:`Fabric.compute_dtype` (None
for f32). More than one device and ``strategy=ddp``/``fsdp`` raise:
multi-device training is ROADMAP queue A item 7.
"""

from __future__ import annotations

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


class Fabric:
    """One process, one device: ``world_size`` 1, rank 0."""

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
        accelerator = str(accelerator or "auto").lower()
        if accelerator not in _ACCELERATORS:
            raise ValueError(f"fabric.accelerator={accelerator!r}: expected one of {sorted(_ACCELERATORS)}")
        if str(devices) not in ("1", "auto") or int(num_nodes) != 1:
            raise NotImplementedError(
                f"fabric.devices={devices} fabric.num_nodes={num_nodes}: the port trains on one device; "
                "multi-device training is ROADMAP queue A item 7"
            )
        if str(strategy or "auto").lower() not in ("auto", "single_device"):
            raise NotImplementedError(
                f"fabric.strategy={strategy}: data-parallel strategies (ddp, fsdp) are ROADMAP queue A item 7"
            )
        compute_dtype_from_precision(precision)  # raises on any other precision
        self.precision = str(precision or "32-true")
        # prng_impl selects the JAX package's key implementation; torch has one generator kind
        del prng_impl
        self.device = resolve_device(_ACCELERATORS[accelerator])
        self.callbacks = list(callbacks or [])

    # -- topology -------------------------------------------------------------

    world_size = 1
    global_rank = 0
    is_global_zero = True

    def launch(self, fn: Callable, *args: Any, **kwargs: Any) -> Any:
        return fn(self, *args, **kwargs)

    def print(self, *args: Any, **kwargs: Any) -> None:
        print(*args, **kwargs)

    # -- precision ------------------------------------------------------------

    @property
    def compute_dtype(self) -> Optional[torch.dtype]:
        """None for f32, bf16 under ``bf16-mixed``: parameters stay f32."""
        return compute_dtype_from_precision(self.precision)

    @property
    def param_dtype(self) -> torch.dtype:
        return torch.float32

    # -- randomness -----------------------------------------------------------

    def seed_everything(self, seed: int) -> Tuple[torch.Generator, np.random.Generator]:
        """Seed Python's ``random`` and return ``(torch generator on the
        device, numpy generator)``, both from ``seed``; the global torch and
        numpy streams are left alone."""
        random.seed(seed)
        return torch.Generator(device=self.device).manual_seed(int(seed)), np.random.default_rng(int(seed))

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

"""Optimizers (counterpart of ``sheeprl_tpu/utils/optim.py``).

The JAX factory ``Adam(lr, betas, eps, weight_decay, max_grad_norm)`` is
``optax.adamw`` when ``weight_decay`` is set (decoupled decay:
``p ← p − lr·(adam_direction + wd·p)``), else ``optax.adam``, chained after
``optax.clip_by_global_norm``. So here ``weight_decay`` selects
``torch.optim.AdamW``, never ``torch.optim.Adam`` (whose decay is an L2 term
added to the gradient), and the clip is the optax form
``g · c / max(‖g‖, c)``: ``torch.nn.utils.clip_grad_norm_`` divides by
``‖g‖ + 1e-6`` instead.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import torch

__all__ = ["Adam", "clip_by_global_norm_", "global_norm"]


def Adam(
    params: Iterable[torch.nn.Parameter],
    lr: float = 1e-3,
    betas: Sequence[float] = (0.9, 0.999),
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> torch.optim.Optimizer:
    """``torch.optim.AdamW`` with decoupled ``weight_decay`` (optax.adamw),
    ``torch.optim.Adam`` without (optax.adam)."""
    b1, b2 = betas
    if weight_decay:
        return torch.optim.AdamW(params, lr=lr, betas=(b1, b2), eps=eps, weight_decay=weight_decay)
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=eps)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every element of every tensor (``optax.global_norm``)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def clip_by_global_norm_(tensors: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: each ``t`` becomes
    ``t / ‖g‖ · max_norm`` when ``‖g‖ ≥ max_norm``. Returns the norm before
    clipping, as a device tensor (no host synchronisation)."""
    norm = global_norm(tensors)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(list(tensors), scale)
    return norm

"""Plain PyTorch versions of the recurrent-cell math (counterpart of
``sheeprl_tpu/kernels/reference.py``).

These run on the CPU, and on the card only where a test or ``chip_smoke.py``
calls them by name to hold the CUDA kernel against them. The joint GRU
kernel keeps the JAX layout, ``[H+X, 3H]`` with the h rows first, which is
also the layout the CUDA kernel reads.
"""

from __future__ import annotations

from typing import Optional

import torch

from sheeprl_tpu_torch.models.norm import fast_layer_norm

__all__ = ["dense_apply", "hafner_cell", "hafner_gates"]


def dense_apply(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``x @ kernel + bias`` on a ``[in, out]`` kernel."""
    y = x @ kernel
    if bias is not None:
        y = y + bias
    return y


def hafner_gates(z: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Gate block on ``z = [reset | cand | update]``: returns the new h."""
    reset, cand, update = torch.chunk(z, 3, dim=-1)
    reset = torch.sigmoid(reset)
    cand = torch.tanh(reset * cand)
    update = torch.sigmoid(update - 1)
    return update * cand + (1 - update) * h


def hafner_cell(
    h: torch.Tensor,
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor],
    ln_scale: Optional[torch.Tensor],
    ln_bias: Optional[torch.Tensor],
    *,
    eps: float,
) -> torch.Tensor:
    """One LayerNorm-GRU step; ``ln_scale=None`` runs it without LayerNorm."""
    z = dense_apply(torch.cat([h, x], dim=-1), kernel, bias)
    if ln_scale is not None:
        z = fast_layer_norm(z, ln_scale, ln_bias, float(eps))
    return hafner_gates(z, h)

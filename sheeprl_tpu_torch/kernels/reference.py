"""Plain PyTorch versions of the recurrent-cell math (counterpart of
``sheeprl_tpu/kernels/reference.py``).

These run on the CPU, and on the card only where a test or ``chip_smoke.py``
calls them by name to hold the CUDA kernel against them. The joint GRU
kernel keeps the JAX layout, ``[H+X, 3H]`` with the h rows first, which is
also the layout the CUDA kernel reads.

The cell has two operand paths, chosen by the dtype of ``x``: f32, and bf16
(the Pallas cell's with bf16 operands, ``pallas_tpu.py:67-76``): ``h`` and
the kernel are rounded to bf16 (to nearest even, as ``astype`` rounds), the
product of the bf16 operands accumulates in f32, and the bias, the
LayerNorm and the gates run in f32 on the f32 ``h``. The new h is f32 on
both paths.
"""

from __future__ import annotations

from typing import Optional

import torch

from sheeprl_tpu_torch.models.norm import fast_layer_norm

__all__ = [
    "bf16_operands",
    "cell_product",
    "dense_apply",
    "hafner_cell",
    "hafner_gates",
    "hafner_norm_gates",
    "hafner_sequence",
    "hafner_sequence_with_z",
]


def dense_apply(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``x @ kernel + bias`` on a ``[in, out]`` kernel."""
    y = x @ kernel
    if bias is not None:
        y = y + bias
    return y


def bf16_operands(h: torch.Tensor, x: torch.Tensor, kernel: torch.Tensor):
    """``(h, x, kernel)`` as the product reads them: rounded to bf16 and held
    in f32 (a product of two bf16 values is exact in f32) when ``x`` is bf16,
    else as they are. Any other dtype of ``x`` raises."""
    if x.dtype == torch.float32:
        return h, x, kernel
    if x.dtype != torch.bfloat16:
        raise TypeError(f"hafner_cell: x must be float32 or bfloat16, got {x.dtype}")
    bf = torch.bfloat16
    return h.to(bf).float(), x.float(), kernel.to(bf).float()


def cell_product(h: torch.Tensor, x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The cell's pre-activation ``z = [h|x]·W + b`` in f32, on the operand
    path of ``x``'s dtype (:func:`bf16_operands`)."""
    h, x, kernel = bf16_operands(h, x, kernel)
    return dense_apply(torch.cat([h, x], dim=-1), kernel, bias)


def hafner_gates(z: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Gate block on ``z = [reset | cand | update]``: returns the new h."""
    reset, cand, update = torch.chunk(z, 3, dim=-1)
    reset = torch.sigmoid(reset)
    cand = torch.tanh(reset * cand)
    update = torch.sigmoid(update - 1)
    return update * cand + (1 - update) * h


def hafner_norm_gates(
    z: torch.Tensor,
    h: torch.Tensor,
    ln_scale: Optional[torch.Tensor],
    ln_bias: Optional[torch.Tensor],
    *,
    eps: float,
) -> torch.Tensor:
    """The cell after its product: LayerNorm (when ``ln_scale`` is given) and
    gates on the pre-activation ``z = [h|x]·W + b``."""
    if ln_scale is not None:
        z = fast_layer_norm(z, ln_scale, ln_bias, float(eps))
    return hafner_gates(z, h)


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
    """One LayerNorm-GRU step; ``ln_scale=None`` runs it without LayerNorm.
    A bf16 ``x`` takes the bf16 operand path (:func:`bf16_operands`)."""
    return hafner_norm_gates(cell_product(h, x, kernel, bias), h, ln_scale, ln_bias, eps=eps)


def hafner_sequence(
    h0: torch.Tensor,
    xs: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor],
    ln_scale: Optional[torch.Tensor],
    ln_bias: Optional[torch.Tensor],
    *,
    eps: float,
) -> torch.Tensor:
    """The cell under a loop over ``xs [T, B, X]`` with h carried from
    ``h0 [B, H]``: returns ``hs [T, B, H]``."""
    return hafner_sequence_with_z(h0, xs, kernel, bias, ln_scale, ln_bias, eps=eps)[0]


def hafner_sequence_with_z(
    h0: torch.Tensor,
    xs: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor],
    ln_scale: Optional[torch.Tensor],
    ln_bias: Optional[torch.Tensor],
    *,
    eps: float,
) -> "tuple[torch.Tensor, torch.Tensor]":
    """:func:`hafner_sequence` (each step :func:`hafner_cell`'s operations)
    that also keeps each step's pre-activation: ``(hs [T,B,H], z [T,B,3H])``."""
    hs, zs = [], []
    h = h0
    for x in xs:
        z = dense_apply(torch.cat([h, x], dim=-1), kernel, bias)
        h = hafner_norm_gates(z, h, ln_scale, ln_bias, eps=eps)
        hs.append(h)
        zs.append(z)
    if not hs:
        return h0.new_empty((0,) + tuple(h0.shape)), h0.new_empty((0, h0.shape[0], 3 * h0.shape[1]))
    return torch.stack(hs), torch.stack(zs)

"""LayerNorm forward with f32 two-pass statistics (counterpart of
``sheeprl_tpu/models/norm.py``).

The JAX module's one-pass custom backward comes with the training slice;
serving needs the forward only.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["FastLayerNorm", "fast_layer_norm"]


def fast_layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float
) -> torch.Tensor:
    """LayerNorm over the last axis. Statistics in f32 from the input as it
    is: the mean first, then the mean of ``(x - mu)^2``, then
    ``rsqrt(var + eps)``. Returns f32."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    xhat = (xf - mu) * torch.rsqrt(var + eps)
    return xhat * weight.float() + bias.float()


class FastLayerNorm(nn.Module):
    """Affine LayerNorm over the last axis; ``weight``/``bias`` hold what the
    JAX module calls ``scale``/``bias``."""

    def __init__(self, features: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = float(eps)
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fast_layer_norm(x, self.weight, self.bias, self.eps).to(
            torch.promote_types(x.dtype, self.weight.dtype)
        )

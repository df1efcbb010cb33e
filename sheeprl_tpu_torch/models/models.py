"""Neural building blocks (counterpart of ``sheeprl_tpu/models/models.py``).

Convolutions run NCHW, PyTorch's native layout. Where the JAX ``CNN``
flattens its NHWC feature map, this one flattens in the same NHWC order, so
the Dense layer after it sees its inputs in the order the JAX weights
expect. The recurrent cell's joint kernel keeps the JAX ``[H+X, 3H]``
layout, the one the CUDA kernel reads.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from sheeprl_tpu_torch.kernels import ops, reference
from sheeprl_tpu_torch.models.norm import FastLayerNorm

__all__ = ["CNN", "MLP", "LayerNormGRUCell", "resolve_activation"]

_ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "tanh": torch.tanh,
    "relu": F.relu,
    "relu6": F.relu6,
    "silu": F.silu,
    "swish": F.silu,
    "elu": F.elu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
    "leaky_relu": F.leaky_relu,
    "sigmoid": torch.sigmoid,
    "softplus": F.softplus,
    "identity": lambda x: x,
    "none": lambda x: x,
}

def resolve_activation(act: Union[str, Callable, None]) -> Callable:
    if act is None:
        return _ACTIVATIONS["identity"]
    if callable(act):
        return act
    name = act.lower()
    if name not in _ACTIVATIONS:
        raise ValueError(f"Unknown activation '{act}'. Known: {sorted(_ACTIVATIONS)}")
    return _ACTIVATIONS[name]


def _broadcast(value: Any, n: int) -> Tuple:
    if isinstance(value, (list, tuple)):
        if len(value) != n:
            raise ValueError(f"Expected {n} per-layer values, got {len(value)}")
        return tuple(value)
    return tuple(value for _ in range(n))


class _Block(nn.Module):
    """Linear → [LayerNorm]."""

    def __init__(self, in_dim, out_dim, bias, layer_norm, norm_eps, device):
        super().__init__()
        self.linear = nn.Linear(in_dim, out_dim, bias=bias, device=device)
        self.norm = FastLayerNorm(out_dim, eps=norm_eps, device=device) if layer_norm else None

    def forward(self, x):
        x = self.linear(x)
        return self.norm(x) if self.norm is not None else x


class MLP(nn.Module):
    """Linear→[LayerNorm]→activation blocks; ``output_dim`` is the last
    block's width."""

    def __init__(
        self,
        input_dim: int,
        hidden_sizes: Sequence[int] = (),
        activation: Union[str, Callable] = "relu",
        layer_norm: Union[bool, Sequence[bool]] = False,
        norm_eps: float = 1e-5,
        bias: Union[bool, Sequence[bool]] = True,
        device=None,
    ):
        super().__init__()
        n = len(hidden_sizes)
        norms = _broadcast(layer_norm, n)
        biases = _broadcast(bias, n)
        self.act = resolve_activation(activation)
        blocks = []
        dim = int(input_dim)
        for i, size in enumerate(hidden_sizes):
            blocks.append(_Block(dim, int(size), biases[i], norms[i], norm_eps, device))
            dim = int(size)
        self.blocks = nn.ModuleList(blocks)
        self.output_dim = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = self.act(block(x))
        return x


class CNN(nn.Module):
    """Conv2d stack on ``[..., C, H, W]``; ``flatten=True`` returns
    ``[..., features]`` flattened in NHWC order (the JAX module's order)."""

    def __init__(
        self,
        in_channels: int,
        channels: Sequence[int],
        kernel_sizes: Union[int, Sequence[int]] = 3,
        strides: Union[int, Sequence[int]] = 1,
        paddings: Union[int, str, Sequence[Any]] = 0,
        activation: Union[str, Callable] = "relu",
        layer_norm: Union[bool, Sequence[bool]] = False,
        norm_eps: float = 1e-5,
        bias: Union[bool, Sequence[bool]] = True,
        flatten: bool = False,
        device=None,
    ):
        super().__init__()
        n = len(channels)
        ks, st, pd = _broadcast(kernel_sizes, n), _broadcast(strides, n), _broadcast(paddings, n)
        norms, biases = _broadcast(layer_norm, n), _broadcast(bias, n)
        self.act = resolve_activation(activation)
        self.flatten = bool(flatten)
        convs, lns = [], []
        c_in = int(in_channels)
        for i, ch in enumerate(channels):
            pad = pd[i].lower() if isinstance(pd[i], str) else int(pd[i])
            convs.append(
                nn.Conv2d(c_in, int(ch), ks[i], stride=st[i], padding=pad, bias=biases[i], device=device)
            )
            lns.append(FastLayerNorm(int(ch), eps=norm_eps, device=device) if norms[i] else None)
            c_in = int(ch)
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList([m if m is not None else nn.Identity() for m in lns])
        self._normed = [m is not None for m in lns]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-3]
        x = x.reshape((-1,) + tuple(x.shape[-3:]))
        for conv, norm, normed in zip(self.convs, self.norms, self._normed):
            x = conv(x)
            if normed:  # LayerNorm over channels, as the JAX module's NHWC LN
                x = norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
            x = self.act(x)
        if self.flatten:
            x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
            return x.reshape(lead + x.shape[1:])
        return x.reshape(lead + x.shape[1:])


class LayerNormGRUCell(nn.Module):
    """Hafner-style GRU cell: one joint Linear over ``[h, x]`` → LayerNorm →
    ``reset, cand, update`` with ``cand = tanh(reset * cand)`` and the update
    gate biased by −1.

    ``weight`` is ``[H+X, 3H]``, h rows first (the JAX ``Dense_0/kernel`` as
    it is). ``impl="auto"`` runs the CUDA kernel on CUDA tensors and the plain
    version on CPU tensors; ``impl="plain"`` runs the plain version anywhere,
    for holding the kernel against it.
    """

    def __init__(
        self,
        input_size: int,
        hidden_size: int,
        bias: bool = True,
        layer_norm: bool = False,
        norm_eps: float = 1e-3,
        impl: str = "auto",
        device=None,
    ):
        super().__init__()
        if impl not in ("auto", "plain"):
            raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
        H = int(hidden_size)
        self.hidden_size = H
        self.input_size = int(input_size)
        self.norm_eps = float(norm_eps)
        self.impl = impl
        self.weight = nn.Parameter(torch.empty(self.input_size + H, 3 * H, device=device))
        nn.init.xavier_uniform_(self.weight)
        self.bias = nn.Parameter(torch.zeros(3 * H, device=device)) if bias else None
        self.norm = FastLayerNorm(3 * H, eps=norm_eps, device=device) if layer_norm else None

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        ln_w = self.norm.weight if self.norm is not None else None
        ln_b = self.norm.bias if self.norm is not None else None
        cell = reference.hafner_cell if self.impl == "plain" else ops.hafner_gru_cell
        return cell(h, x, self.weight, self.bias, ln_w, ln_b, eps=self.norm_eps)

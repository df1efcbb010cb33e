"""Neural building blocks (counterpart of ``sheeprl_tpu/models/models.py``).

Convolutions run NCHW, PyTorch's native layout. Where the JAX ``CNN``
flattens its NHWC feature map, this one flattens in the same NHWC order, so
the Dense layer after it sees its inputs in the order the JAX weights
expect. The recurrent cell's joint kernel keeps the JAX ``[H+X, 3H]``
layout, the one the CUDA kernel reads.

Every module takes a compute ``dtype`` (None: f32), the JAX modules'
``dtype`` under ``fabric.precision=bf16-mixed``: parameters stay f32 and
are cast, with the input, to ``dtype`` at each call, as flax's
``promote_dtype`` does; with None, the input and the parameters are
promoted to their common dtype.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from sheeprl_tpu_torch.kernels import ops, reference
from sheeprl_tpu_torch.models.norm import FastLayerNorm

__all__ = ["CNN", "Conv2d", "ConvTranspose2d", "DeCNN", "GRUCell", "LSTMCell", "Linear", "MLP", "LayerNormGRUCell",
           "NatureCNN", "resolve_activation"]

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


def _promote(dtype: Optional[torch.dtype], x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]):
    """``(x, weight, bias)`` in the compute dtype (flax's ``promote_dtype``)."""
    dt = dtype or torch.promote_types(x.dtype, weight.dtype)
    return x.to(dt), weight.to(dt), None if bias is None else bias.to(dt)


class Linear(nn.Linear):
    """``nn.Linear`` (the same parameters) computing in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, device=None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias=bias, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(*_promote(self.compute_dtype, x, self.weight, self.bias))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``dtype``."""

    def __init__(self, *args, dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(*_promote(self.compute_dtype, x, self.weight, self.bias))


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` computing in ``dtype``."""

    def __init__(self, *args, dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = _promote(self.compute_dtype, x, self.weight, self.bias)
        return F.conv_transpose2d(x, w, b, self.stride, self.padding, self.output_padding, self.groups, self.dilation)


class _Block(nn.Module):
    """Linear → [LayerNorm]."""

    def __init__(self, in_dim, out_dim, bias, layer_norm, norm_eps, device, dtype=None):
        super().__init__()
        self.linear = Linear(in_dim, out_dim, bias=bias, device=device, dtype=dtype)
        self.norm = FastLayerNorm(out_dim, eps=norm_eps, device=device, dtype=dtype) if layer_norm else None

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
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        n = len(hidden_sizes)
        norms = _broadcast(layer_norm, n)
        biases = _broadcast(bias, n)
        self.act = resolve_activation(activation)
        blocks = []
        dim = int(input_dim)
        for i, size in enumerate(hidden_sizes):
            blocks.append(_Block(dim, int(size), biases[i], norms[i], norm_eps, device, dtype))
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
        dtype: Optional[torch.dtype] = None,
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
                Conv2d(c_in, int(ch), ks[i], stride=st[i], padding=pad, bias=biases[i], device=device, dtype=dtype)
            )
            lns.append(FastLayerNorm(int(ch), eps=norm_eps, device=device, dtype=dtype) if norms[i] else None)
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


class DeCNN(nn.Module):
    """ConvTranspose2d stack on ``[..., C, H, W]`` (the JAX ``DeCNN``).

    ``paddings`` are PyTorch-style transposed-conv paddings ``p`` (output
    ``(in - 1)·s − 2p + k``), which is what the configs carry: the JAX module
    turns ``p`` into flax's forward-conv padding ``k − 1 − p`` per side and
    runs ``ConvTranspose(transpose_kernel=True)``, the gradient of a forward
    convolution, as ``nn.ConvTranspose2d`` is. The activation follows every
    layer but the last, which ``final_activation`` follows (none by default).
    """

    def __init__(
        self,
        in_channels: int,
        channels: Sequence[int],
        kernel_sizes: Union[int, Sequence[int]] = 3,
        strides: Union[int, Sequence[int]] = 1,
        paddings: Union[int, Sequence[int]] = 0,
        activation: Union[str, Callable] = "relu",
        layer_norm: Union[bool, Sequence[bool]] = False,
        norm_eps: float = 1e-5,
        bias: Union[bool, Sequence[bool]] = True,
        final_activation: Union[str, Callable, None] = None,
        device=None,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        n = len(channels)
        ks, st, pd = _broadcast(kernel_sizes, n), _broadcast(strides, n), _broadcast(paddings, n)
        norms, biases = _broadcast(layer_norm, n), _broadcast(bias, n)
        self.act = resolve_activation(activation)
        self.final_act = resolve_activation(final_activation)
        convs, lns = [], []
        c_in = int(in_channels)
        for i, ch in enumerate(channels):
            convs.append(
                ConvTranspose2d(
                    c_in, int(ch), ks[i], stride=st[i], padding=int(pd[i]), bias=biases[i], device=device, dtype=dtype
                )
            )
            lns.append(FastLayerNorm(int(ch), eps=norm_eps, device=device, dtype=dtype) if norms[i] else None)
            c_in = int(ch)
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList([m if m is not None else nn.Identity() for m in lns])
        self._normed = [m is not None for m in lns]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-3]
        x = x.reshape((-1,) + tuple(x.shape[-3:]))
        last = len(self.convs) - 1
        for i, (conv, norm, normed) in enumerate(zip(self.convs, self.norms, self._normed)):
            x = conv(x)
            if normed:  # LayerNorm over channels, as the JAX module's NHWC LN
                x = norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
            x = self.act(x) if i < last else self.final_act(x)
        return x.reshape(lead + x.shape[1:])


class LayerNormGRUCell(nn.Module):
    """Hafner-style GRU cell: one joint Linear over ``[h, x]`` → LayerNorm →
    ``reset, cand, update`` with ``cand = tanh(reset * cand)`` and the update
    gate biased by −1.

    ``weight`` is ``[H+X, 3H]``, h rows first (the JAX ``Dense_0/kernel`` as
    it is). ``impl="auto"`` runs the CUDA kernel on CUDA tensors and the plain
    version on CPU tensors; ``impl="plain"`` runs the plain version anywhere,
    for holding the kernel against it.

    With ``dtype=torch.bfloat16`` the input goes to the cell in bf16 and the
    cell takes its bf16 operand path (``h``, ``x`` and the kernel rounded to
    bf16, the product accumulated in f32, the LayerNorm and the gates in
    f32); the new h is f32, the carried state's dtype, as the JAX module
    casts it back.
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
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        if dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"LayerNormGRUCell: dtype must be None, float32 or bfloat16, got {dtype}")
        if impl not in ("auto", "plain"):
            raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
        H = int(hidden_size)
        self.hidden_size = H
        self.input_size = int(input_size)
        self.norm_eps = float(norm_eps)
        self.impl = impl
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(self.input_size + H, 3 * H, device=device))
        nn.init.xavier_uniform_(self.weight)
        self.bias = nn.Parameter(torch.zeros(3 * H, device=device)) if bias else None
        self.norm = FastLayerNorm(3 * H, eps=norm_eps, device=device) if layer_norm else None

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        ln_w = self.norm.weight if self.norm is not None else None
        ln_b = self.norm.bias if self.norm is not None else None
        cell = reference.hafner_cell if self.impl == "plain" else ops.hafner_gru_cell
        x = x.to(self.dtype or torch.float32)
        return cell(h.float(), x, self.weight, self.bias, ln_w, ln_b, eps=self.norm_eps)


#: the flax ``nn.GRUCell``'s six projections: the input's three (with bias), then the state's (``hn`` alone with bias)
GRU_PROJECTIONS = (("ir", True), ("iz", True), ("in", True), ("hr", False), ("hz", False), ("hn", True))


class GRUCell(nn.Module):
    """flax's ``nn.GRUCell`` (DreamerV1's recurrent core; the JAX
    ``FusedGRUCell`` with ``fused="off"``): six Linear projections named
    after its leaves, ``ir``, ``iz``, ``in`` of the input and ``hr``, ``hz``,
    ``hn`` of the state (only ``hn`` of the three with a bias), and

        r = σ(ir + hr); z = σ(iz + hz); n = tanh(in + r·hn); h' = (1−z)·n + z·h.

    PyTorch operations on any device (the JAX package computes it outside
    any Pallas kernel): the three input projections are one product, and so
    are the three state projections."""

    def __init__(self, input_size: int, hidden_size: int, device=None):
        super().__init__()
        self.input_size, self.hidden_size = int(input_size), int(hidden_size)
        for name, bias in GRU_PROJECTIONS:
            width = self.input_size if name.startswith("i") else self.hidden_size
            self.add_module(name, nn.Linear(width, self.hidden_size, bias=bias, device=device))

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        m = self._modules
        xi = F.linear(x, torch.cat([m["ir"].weight, m["iz"].weight, m["in"].weight]),
                      torch.cat([m["ir"].bias, m["iz"].bias, m["in"].bias]))
        hh = F.linear(h, torch.cat([m["hr"].weight, m["hz"].weight, m["hn"].weight]))
        ir, iz, in_ = xi.chunk(3, dim=-1)
        hr, hz, hn = hh.chunk(3, dim=-1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        n = torch.tanh(in_ + r * (hn + m["hn"].bias))
        return (1.0 - z) * n + z * h


class NatureCNN(nn.Module):
    """The DQN-Nature encoder (the JAX ``NatureCNN``): three VALID ReLU
    convolutions (32 channels 8×8 stride 4, 64 4×4 stride 2, 64 3×3 stride
    1), the map flattened in NHWC order, then a ReLU Linear of
    ``features_dim``. Input ``[..., C, H, W]`` with ``H = W = screen_size``."""

    LAYERS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))

    def __init__(self, in_channels: int, features_dim: int = 512, screen_size: int = 64, device=None):
        super().__init__()
        self.cnn = CNN(in_channels, [c for c, _, _ in self.LAYERS], [k for _, k, _ in self.LAYERS],
                       [s for _, _, s in self.LAYERS], 0, "relu", flatten=True, device=device)
        side = int(screen_size)
        for _, k, s in self.LAYERS:
            side = (side - k) // s + 1
        self.fc = Linear(self.LAYERS[-1][0] * side * side, int(features_dim), device=device)
        self.output_dim = int(features_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.fc(self.cnn(x)))


#: flax ``nn.OptimizedLSTMCell``'s eight projections, gate order i, f, g, o: the input's (no bias), the state's (bias)
LSTM_PROJECTIONS = tuple((f"i{g}", False) for g in "ifgo") + tuple((f"h{g}", True) for g in "ifgo")


class LSTMCell(nn.Module):
    """flax's ``nn.OptimizedLSTMCell`` (PPO-recurrent's core): eight Linear
    projections named after its leaves, ``ii if ig io`` of the input (no
    bias) and ``hi hf hg ho`` of the state (with bias), and

        i = σ(hi + ii); f = σ(hf + if); g = tanh(hg + ig); o = σ(ho + io);
        c' = f·c + i·g; h' = o·tanh(c').

    The carry is ``(c, h)``. The four input projections are one product, and
    so are the four state projections, as in flax. PyTorch operations on any
    device: the JAX package computes it outside any Pallas kernel."""

    def __init__(self, input_size: int, hidden_size: int, device=None):
        super().__init__()
        self.input_size, self.hidden_size = int(input_size), int(hidden_size)
        for name, bias in LSTM_PROJECTIONS:
            width = self.input_size if name.startswith("i") else self.hidden_size
            self.add_module(name, nn.Linear(width, self.hidden_size, bias=bias, device=device))

    def forward(self, x: torch.Tensor, carry: Tuple[torch.Tensor, torch.Tensor]):
        c, h = carry
        m = self._modules
        dense_h = F.linear(h, torch.cat([m[f"h{g}"].weight for g in "ifgo"]),
                           torch.cat([m[f"h{g}"].bias for g in "ifgo"]))
        dense_i = F.linear(x, torch.cat([m[f"i{g}"].weight for g in "ifgo"]))
        z = dense_h + dense_i
        zi, zf, zg, zo = z.chunk(4, dim=-1)
        c = torch.sigmoid(zf) * c + torch.sigmoid(zi) * torch.tanh(zg)
        h = torch.sigmoid(zo) * torch.tanh(c)
        return c, h

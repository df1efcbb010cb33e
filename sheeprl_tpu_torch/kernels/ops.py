"""Kernel wrappers: the only entry points the models call.

Each wrapper picks its implementation by the device of the tensors it is
given: on a CUDA tensor it launches the hand-written kernel (and raises if
that fails: there is no quiet switch to the plain version); on a CPU tensor
it runs the plain PyTorch version from :mod:`.reference`. Every launch adds
one to the kernel's :class:`LaunchCounter`, so a run can show that its main
path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from sheeprl_tpu_torch.kernels import reference

__all__ = ["LaunchCounter", "hafner_cell_cuda", "hafner_cell_launches", "hafner_gru_cell"]


class LaunchCounter:
    """A plain count of kernel launches (``reset()`` before a measured run)."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def reset(self) -> None:
        self.count = 0


#: launches of the ``hafner_gru.cu`` cell kernel in this process
hafner_cell_launches = LaunchCounter("hafner_cell")


@functools.lru_cache(maxsize=None)
def _hafner_lib():
    from sheeprl_tpu_torch.kernels.build import load_library

    lib = load_library("hafner_gru")
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    lib.hafner_cell_forward.argtypes = [ptr] * 8 + [c_int] * 4 + [ctypes.c_float, c_int, ptr]
    lib.hafner_cell_forward.restype = c_int
    lib.hafner_cell_split_chunks.argtypes = [c_int] * 3
    lib.hafner_cell_split_chunks.restype = c_int
    lib.hafner_cell_chunk_rows.restype = c_int
    lib.hafner_cell_error_string.argtypes = [c_int]
    lib.hafner_cell_error_string.restype = ctypes.c_char_p
    return lib


def _check_operand(name: str, t: Optional[torch.Tensor], shape, device) -> None:
    if t is None:
        return
    if t.device != device:
        raise ValueError(f"hafner_cell: {name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"hafner_cell: {name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"hafner_cell: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"hafner_cell: {name} must be contiguous")


def hafner_cell_cuda(
    h: torch.Tensor,
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor],
    ln_scale: Optional[torch.Tensor],
    ln_bias: Optional[torch.Tensor],
    *,
    eps: float,
) -> torch.Tensor:
    """Launch the CUDA cell on CUDA tensors: ``h [B,H]``, ``x [B,X]``,
    ``kernel [H+X, 3H]``, ``bias``/``ln_scale``/``ln_bias`` ``[3H]`` or None."""
    if h.device.type != "cuda":
        raise ValueError(f"hafner_cell_cuda needs CUDA tensors, got {h.device}")
    if h.dim() != 2 or x.dim() != 2:
        raise ValueError("hafner_cell: h and x must be [B, H] and [B, X]")
    B, H = h.shape
    X = x.shape[1]
    if (ln_scale is None) != (ln_bias is None):
        raise ValueError("hafner_cell: ln_scale and ln_bias come together")
    for name, t, shape in (
        ("h", h, (B, H)),
        ("x", x, (B, X)),
        ("kernel", kernel, (H + X, 3 * H)),
        ("bias", bias, (3 * H,)),
        ("ln_scale", ln_scale, (3 * H,)),
        ("ln_bias", ln_bias, (3 * H,)),
    ):
        _check_operand(name, t, shape, h.device)
    if B == 0:
        return torch.empty_like(h)
    lib = _hafner_lib()
    with torch.cuda.device(h.device):  # the launching thread's current device
        split_chunks = lib.hafner_cell_split_chunks(B, H, X)
        if split_chunks < 1:
            raise RuntimeError(f"hafner_cell: cannot query {h.device}")
        chunks = -(-(H + X) // lib.hafner_cell_chunk_rows())
        splits = -(-chunks // split_chunks)
        out = torch.empty_like(h)
        zpart = torch.empty((splits, B, 3 * H), dtype=torch.float32, device=h.device)
        operands = (h, x, kernel, bias, ln_scale, ln_bias, zpart, out)
        vec = int(H % 4 == 0 and X % 4 == 0 and all(t is None or t.data_ptr() % 16 == 0 for t in operands))

        def ptr(t: Optional[torch.Tensor]):
            return None if t is None else t.data_ptr()

        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = lib.hafner_cell_forward(
            ptr(h), ptr(x), ptr(kernel), ptr(bias), ptr(ln_scale), ptr(ln_bias), ptr(zpart), ptr(out),
            B, H, X, split_chunks, float(eps), vec, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"hafner_cell kernel launch failed (B={B}, H={H}, X={X}): "
            f"{lib.hafner_cell_error_string(err).decode()}"
        )
    hafner_cell_launches.count += 1
    return out


class _HafnerCell(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, x, kernel, bias, ln_scale, ln_bias, eps):
        if h.device.type == "cpu":
            return reference.hafner_cell(h, x, kernel, bias, ln_scale, ln_bias, eps=eps)
        return hafner_cell_cuda(h, x, kernel, bias, ln_scale, ln_bias, eps=eps)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError("backward kernel comes with the training slice")


def hafner_gru_cell(
    h: torch.Tensor,
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor],
    ln_scale: Optional[torch.Tensor],
    ln_bias: Optional[torch.Tensor],
    *,
    eps: float,
) -> torch.Tensor:
    """One LayerNorm-GRU step: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors."""
    return _HafnerCell.apply(h, x, kernel, bias, ln_scale, ln_bias, float(eps))

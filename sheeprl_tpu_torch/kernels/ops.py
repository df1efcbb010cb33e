"""Kernel wrappers: the only entry points the models call.

Each wrapper picks its implementation by the device of the tensors it is
given: on a CUDA tensor it launches the hand-written kernel (and raises if
that fails: there is no quiet switch to the plain version); on a CPU tensor
it runs the plain PyTorch version from :mod:`.reference`. Every launch adds
one to the kernel's :class:`LaunchCounter`, so a run can show that its main
path went through the kernel.

Gradients. The JAX package has no backward kernel: its Pallas cell and
sequence are ``jax.custom_vjp``s whose backward is ``jax.vjp`` of the XLA
program (``pallas_tpu.py:149-160``, ``:200-232``). Here the backward is a
hand-derived VJP in PyTorch operations, the same code on CPU and CUDA
tensors. When an operand needs a gradient, the cell's forward keeps its
pre-activation ``z = [h|x]·W + b`` (the CUDA gate kernel writes out the row
it holds; the CPU path computes ``z`` once and runs the plain LayerNorm and
gates on it), and the backward differentiates the two-pass LayerNorm and the
gates by hand at that ``z``: no product is recomputed. The sequence keeps
its steps' ``z [T, B, 3H]`` the same way (both CUDA variants write it), and
its backward runs the same VJP in reverse over T at the kept ``z``. Neither
calls the plain forward.

The sequence has two CUDA variants, chosen by a plan made before the launch
(:func:`hafner_sequence_variant`): the persistent recurrence (one
cooperative launch after the input projection) where its shape fits the
card, else the multi-launch one (two launches a step).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from sheeprl_tpu_torch.kernels import reference

__all__ = [
    "LaunchCounter",
    "hafner_cell_cuda",
    "hafner_cell_launches",
    "hafner_cell_variant",
    "hafner_gru_cell",
    "hafner_gru_sequence",
    "hafner_sequence_cuda",
    "hafner_sequence_launches",
    "hafner_sequence_variant",
    "hafner_sync_floor_cuda",
]

#: the two CUDA variants of the sequence's recurrence
SEQUENCE_VARIANTS = ("persistent", "multi_launch")


class LaunchCounter:
    """A plain count of kernel launches (``reset()`` before a measured run),
    and the same count by variant where a kernel has several."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.by_variant: dict = {}

    def add(self, variant: Optional[str] = None) -> None:
        self.count += 1
        if variant is not None:
            self.by_variant[variant] = self.by_variant.get(variant, 0) + 1

    def reset(self) -> None:
        self.count = 0
        self.by_variant = {}


#: launches of the ``hafner_gru.cu`` cell (one per step)
hafner_cell_launches = LaunchCounter("hafner_cell")
#: launches of the ``hafner_gru.cu`` sequence (one per whole sequence), by variant
hafner_sequence_launches = LaunchCounter("hafner_sequence")


@functools.lru_cache(maxsize=None)
def _hafner_lib():
    from sheeprl_tpu_torch.kernels.build import load_library

    lib = load_library("hafner_gru")
    ptr, c_int, c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.hafner_cell_forward.argtypes = [ptr] * 9 + [c_int] * 4 + [c_float, c_int, ptr]
    lib.hafner_cell_forward.restype = c_int
    lib.hafner_sequence_forward.argtypes = [ptr] * 12 + [c_int] * 6 + [c_float, c_int, c_int, ptr]
    lib.hafner_sequence_forward.restype = c_int
    lib.hafner_sequence_plan.argtypes = [c_int, c_int, ctypes.POINTER(c_int)]
    lib.hafner_sequence_plan.restype = c_int
    lib.hafner_sync_floor.argtypes = [c_int, c_int, c_int, ptr, ptr]
    lib.hafner_sync_floor.restype = c_int
    lib.hafner_split_chunks.argtypes = [c_int] * 3
    lib.hafner_split_chunks.restype = c_int
    lib.hafner_chunk_rows.restype = c_int
    lib.hafner_product_shape.argtypes = [c_int, c_int, ctypes.POINTER(c_int), ctypes.POINTER(c_int)]
    lib.hafner_product_shape.restype = c_int
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


def _check_params(h, kernel, bias, ln_scale, ln_bias, H: int, X: int) -> None:
    if (ln_scale is None) != (ln_bias is None):
        raise ValueError("hafner_cell: ln_scale and ln_bias come together")
    for name, t, shape in (
        ("kernel", kernel, (H + X, 3 * H)),
        ("bias", bias, (3 * H,)),
        ("ln_scale", ln_scale, (3 * H,)),
        ("ln_bias", ln_bias, (3 * H,)),
    ):
        _check_operand(name, t, shape, h.device)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _vec(H: int, X: int, *operands) -> int:
    """16-byte copies: every width a multiple of 4 floats, every pointer aligned."""
    return int(H % 4 == 0 and X % 4 == 0 and all(t is None or t.data_ptr() % 16 == 0 for t in operands))


def _splits(lib, M: int, K: int, N: int, device) -> "tuple[int, int]":
    """``(chunks per split, splits)`` of an ``[M, K]·[K, N]`` product."""
    split_chunks = lib.hafner_split_chunks(M, K, N)
    if split_chunks < 1:
        raise RuntimeError(f"hafner_cell: cannot query {device}")
    chunks = -(-K // lib.hafner_chunk_rows())
    return split_chunks, -(-chunks // split_chunks)


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: {lib.hafner_cell_error_string(err).decode()}")


def hafner_cell_cuda(
    h: torch.Tensor,
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor],
    ln_scale: Optional[torch.Tensor],
    ln_bias: Optional[torch.Tensor],
    *,
    eps: float,
    save_z: bool = False,
):
    """Launch the CUDA cell on CUDA tensors: ``h [B,H]``, ``x [B,X]``,
    ``kernel [H+X, 3H]``, ``bias``/``ln_scale``/``ln_bias`` ``[3H]`` or None.
    Returns ``h'``, or ``(h', z)`` with the pre-LayerNorm ``z [B, 3H]`` when
    ``save_z``."""
    if h.device.type != "cuda":
        raise ValueError(f"hafner_cell_cuda needs CUDA tensors, got {h.device}")
    if h.dim() != 2 or x.dim() != 2:
        raise ValueError("hafner_cell: h and x must be [B, H] and [B, X]")
    B, H = h.shape
    X = x.shape[1]
    _check_operand("h", h, (B, H), h.device)
    _check_operand("x", x, (B, X), h.device)
    _check_params(h, kernel, bias, ln_scale, ln_bias, H, X)
    if B == 0:
        out = torch.empty_like(h)
        return (out, h.new_empty((0, 3 * H))) if save_z else out
    lib = _hafner_lib()
    with torch.cuda.device(h.device):  # the launching thread's current device
        split_chunks, splits = _splits(lib, B, H + X, 3 * H, h.device)
        out = torch.empty_like(h)
        zpart = torch.empty((splits, B, 3 * H), dtype=torch.float32, device=h.device)
        # with one split the gate kernel writes z over the partial it reads
        z = None if not save_z else (zpart[0] if splits == 1 else torch.empty_like(zpart[0]))
        vec = _vec(H, X, h, x, kernel, bias, ln_scale, ln_bias, zpart, z, out)
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = lib.hafner_cell_forward(
            _ptr(h), _ptr(x), _ptr(kernel), _ptr(bias), _ptr(ln_scale), _ptr(ln_bias), _ptr(zpart), _ptr(z),
            _ptr(out), B, H, X, split_chunks, float(eps), vec, stream,
        )
    _raise_on(lib, err, f"hafner_cell (B={B}, H={H}, X={X})")
    hafner_cell_launches.add()
    return (out, z) if save_z else out


def hafner_cell_variant(B: int, H: int, X: int, device="cuda") -> dict:
    """Which hand-written product variant the cell launches at this shape:
    batch rows per block (the wgmma N), warpgroups per block, K splits and
    the grid."""
    lib = _hafner_lib()
    tile, wg = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        split_chunks, splits = _splits(lib, B, H + X, 3 * H, device)
        err = lib.hafner_product_shape(B, 3 * H, ctypes.byref(tile), ctypes.byref(wg))
    if err != 0:
        raise RuntimeError(f"hafner_cell: cannot query {device}")
    tile, wg = tile.value, wg.value
    return {
        "product": f"wgmma.m64n{tile}k8.f32.tf32 x3 (3xTF32), {wg} warpgroup(s) a block",
        "tile_rows": tile,
        "warpgroups": wg,
        "splits": splits,
        "chunks_per_split": split_chunks,
        "grid": [-(-3 * H // (64 * wg)), -(-B // tile), splits],
    }


# the persistent recurrence's partition, as ``hafner_gru.cu`` sets it: hidden
# units per unit group (kUnits), K slices a cluster (kKSplit), the wgmma M
# tile (kTileM), the partial tile's row stride and a warp's floats of h_{t-1}
# (kPartStride, kHPad), unit groups a row's statistics merge (kMaxGroups), a block's
# shared-memory ceiling (kMaxSmem)
_UNITS, _KSPLIT, _TILE_M, _PART_STRIDE, _HPAD, _MAX_GROUPS, _MAX_SMEM = 21, 4, 64, 68, 32, 64, 232448


def sequence_shape(B: int, H: int) -> dict:
    """The persistent recurrence's shape for ``B`` batch rows and ``H``
    hidden units (``sequence_shape`` and ``recurrence_warps`` in
    ``hafner_gru.cu``): the wgmma N, the K rows a block holds, warps a
    block, unit groups, blocks, shared memory a block, and
    whether it fits at all (``B <= 64``, at most 64 unit groups, at most
    227 KB a block). Whether every block is co-resident is the card's answer
    (:func:`hafner_sequence_variant`)."""
    cdiv = lambda a, b: -(-a // b)  # noqa: E731
    nt = 8 if B <= 8 else 16 if B <= 16 else 32 if B <= 32 else 64
    warps = max(8, nt // _KSPLIT)
    k_align = 8 * (warps // 4)  # the k8 steps split evenly over the warpgroups
    kq = k_align * cdiv(cdiv(H, _KSPLIT), k_align)
    groups = cdiv(H, _UNITS)
    floats = (2 * _TILE_M * kq + 2 * nt * kq + nt * _PART_STRIDE + (nt // _KSPLIT) * _TILE_M + warps * _HPAD
              + 3 * _TILE_M)
    smem = 4 * floats
    return {"tile_rows": nt, "k_rows": kq, "warps": warps, "unit_groups": groups,
            "blocks": groups * _KSPLIT,
            "smem_bytes": smem, "fits": B <= 64 and groups <= _MAX_GROUPS and smem <= _MAX_SMEM}


@functools.lru_cache(maxsize=None)
def _sequence_plan(B: int, H: int, index: int) -> "tuple[int, ...]":
    """``hafner_sequence_plan`` on device ``index``: (persistent, N, K rows,
    unit groups, blocks, shared memory, co-resident clusters)."""
    lib = _hafner_lib()
    out = (ctypes.c_int * 7)()
    with torch.cuda.device(index):
        err = lib.hafner_sequence_plan(B, H, out)
    _raise_on(lib, err, f"hafner_sequence plan (B={B}, H={H})")
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _barrier_word(index: int) -> torch.Tensor:
    """The zeroed word the persistent recurrence's hand-written grid barrier
    counts on, one per device, made on first use (outside any graph capture,
    so that later captures and replays use a word that exists and is zero)."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("hafner_sequence: make the first persistent call on a device outside a CUDA-graph capture")
    return torch.zeros(4, dtype=torch.int32, device=torch.device("cuda", index))


def _device_index(device) -> int:
    device = torch.device(device)
    return device.index if device.index is not None else torch.cuda.current_device()


def hafner_sequence_variant(T: int, B: int, H: int, X: int, device="cuda") -> dict:
    """Which recurrence the sequence launches at this shape, from a plan made
    before the launch: ``persistent`` (the input projection, then one
    cooperative launch that keeps ``W[:H]`` on chip for all T steps) where
    :func:`sequence_shape` fits and the card holds every block at once (the
    occupancy query), else ``multi_launch`` (two launches a step). With the
    device launches a call makes and the persistent kernel's shape."""
    shape = sequence_shape(B, H)
    plan = _sequence_plan(B, H, _device_index(device))
    if plan[1:6] != (shape["tile_rows"], shape["k_rows"], shape["unit_groups"], shape["blocks"], shape["smem_bytes"]):
        raise RuntimeError(f"sequence_shape disagrees with hafner_gru.cu's: {shape} against {plan}")
    persistent = bool(plan[0])
    return {
        "variant": SEQUENCE_VARIANTS[0] if persistent else SEQUENCE_VARIANTS[1],
        "device_launches_per_call": int(X > 0) + (1 if persistent else 2 * T),
        "persistent_product": f"wgmma.m64n{shape['tile_rows']}k8.f32.tf32 x3 (3xTF32), both operands in shared memory",
        "co_resident_clusters": plan[6],
        "cluster_blocks": _KSPLIT,
        **shape,
    }


def hafner_sequence_cuda(
    h0: torch.Tensor,
    xs: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor],
    ln_scale: Optional[torch.Tensor],
    ln_bias: Optional[torch.Tensor],
    *,
    eps: float,
    save_z: bool = False,
    variant: Optional[str] = None,
):
    """Launch the CUDA sequence on CUDA tensors: ``h0 [B,H]``, ``xs [T,B,X]``
    → ``hs [T,B,H]``, or ``(hs, z)`` with the pre-LayerNorm ``z [T,B,3H]``
    when ``save_z``; parameters as for :func:`hafner_cell_cuda`. ``variant``
    None takes the plan's (:func:`hafner_sequence_variant`); naming one
    launches it, and ``persistent`` raises where it does not fit."""
    if h0.device.type != "cuda":
        raise ValueError(f"hafner_sequence_cuda needs CUDA tensors, got {h0.device}")
    if h0.dim() != 2 or xs.dim() != 3:
        raise ValueError("hafner_sequence: h0 and xs must be [B, H] and [T, B, X]")
    if variant is not None and variant not in SEQUENCE_VARIANTS:
        raise ValueError(f"hafner_sequence: variant must be one of {SEQUENCE_VARIANTS}, got {variant!r}")
    B, H = h0.shape
    T, X = xs.shape[0], xs.shape[2]
    _check_operand("h0", h0, (B, H), h0.device)
    _check_operand("xs", xs, (T, B, X), h0.device)
    _check_params(h0, kernel, bias, ln_scale, ln_bias, H, X)
    if T == 0 or B == 0:
        hs = torch.empty((T, B, H), dtype=torch.float32, device=h0.device)
        return (hs, hs.new_empty((T, B, 3 * H))) if save_z else hs
    lib = _hafner_lib()
    with torch.cuda.device(h0.device):
        index = torch.cuda.current_device()
        plan = hafner_sequence_variant(T, B, H, X, index)
        variant = variant or plan["variant"]
        persistent = variant == "persistent"
        if persistent and plan["variant"] != "persistent":
            raise ValueError(f"hafner_sequence: the persistent recurrence does not fit (B={B}, H={H}): {plan}")
        f32 = dict(dtype=torch.float32, device=h0.device)
        x_chunks, x_splits = _splits(lib, T * B, X, 3 * H, h0.device) if X > 0 else (0, 0)
        zx = torch.empty((x_splits, T, B, 3 * H), **f32)
        if persistent:
            h_chunks, zpart = 0, None
            stats = torch.empty((2, B, plan["unit_groups"], 2), **f32)
            barrier = _barrier_word(index)
        else:
            h_chunks, h_splits = _splits(lib, B, H, 3 * H, h0.device)
            zpart, stats, barrier = torch.empty((h_splits, B, 3 * H), **f32), None, None
        hs = torch.empty((T, B, H), **f32)
        z = torch.empty((T, B, 3 * H), **f32) if save_z else None
        vec = _vec(H, X, h0, xs, kernel, bias, ln_scale, ln_bias, zx, zpart, hs, z)
        stream = torch.cuda.current_stream(h0.device).cuda_stream
        err = lib.hafner_sequence_forward(
            _ptr(h0), _ptr(xs), _ptr(kernel), _ptr(bias), _ptr(ln_scale), _ptr(ln_bias), _ptr(zx), _ptr(zpart),
            _ptr(z), _ptr(stats), _ptr(barrier), _ptr(hs), T, B, H, X, x_chunks, h_chunks, float(eps), vec,
            int(persistent), stream,
        )
    _raise_on(lib, err, f"hafner_sequence {variant} (T={T}, B={B}, H={H}, X={X})")
    hafner_sequence_launches.add(variant)
    return (hs, z) if save_z else hs


def hafner_sync_floor_cuda(B: int, H: int, iters: int, device="cuda") -> None:
    """Launch, on the current stream, the persistent recurrence's
    synchronisation alone at its grid for ``(B, H)``: ``iters`` x (a cluster
    barrier and two grid barriers), the floor under a LayerNorm step. For
    measurement; no path of the port calls it."""
    lib = _hafner_lib()
    with torch.cuda.device(device):
        index = torch.cuda.current_device()
        stream = torch.cuda.current_stream(index).cuda_stream
        err = lib.hafner_sync_floor(B, H, iters, _ptr(_barrier_word(index)), stream)
    _raise_on(lib, err, f"hafner_sync_floor (B={B}, H={H})")


# ---------------------------------------------------------------------------
# the hand-derived VJP
# ---------------------------------------------------------------------------


def _gates_vjp(z, h, ln_scale, ln_bias, eps: float, g):
    """VJP of the LayerNorm (two-pass statistics, as ``models/norm.py``) and
    the gates at the pre-activation ``z = [h|x]·W + b`` for the output
    cotangent ``g``. Returns ``(dz, dh through the (1-u)·h term, dscale,
    dlbias)``; the LayerNorm parameters' grads are None without LayerNorm."""
    if ln_scale is not None:
        mu = z.mean(dim=-1, keepdim=True)
        d = z - mu
        rstd = torch.rsqrt(d.square().mean(dim=-1, keepdim=True) + eps)
        zhat = d * rstd
        y = zhat * ln_scale + ln_bias
    else:
        y = z
    y_r, y_c, y_u = torch.chunk(y, 3, dim=-1)
    r = torch.sigmoid(y_r)
    c = torch.tanh(r * y_c)
    u = torch.sigmoid(y_u - 1)
    d_pre_c = g * u * (1 - c * c)  # through h' = u·c + (1-u)·h, c = tanh(r·y_c)
    dy = torch.cat([d_pre_c * y_c * r * (1 - r), d_pre_c * r, g * (c - h) * u * (1 - u)], dim=-1)
    dh = g * (1 - u)
    if ln_scale is None:
        return dy, dh, None, None
    rows = tuple(range(dy.dim() - 1))
    dlbias = dy.sum(dim=rows)
    dscale = (dy * zhat).sum(dim=rows)
    gg = dy * ln_scale
    dz = rstd * (gg - gg.mean(dim=-1, keepdim=True) - zhat * (gg * zhat).mean(dim=-1, keepdim=True))
    return dz, dh, dscale, dlbias


class _HafnerCell(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, x, kernel, bias, ln_scale, ln_bias, eps, save_z):
        """``save_z``: keep the pre-activation for the backward (the caller
        knows whether a graph is recorded; inside ``forward`` grad mode is off)."""
        ctx.eps = eps
        if h.device.type == "cpu":  # reference.hafner_cell, with z kept
            z = reference.dense_apply(torch.cat([h, x], dim=-1), kernel, bias)
            out = reference.hafner_norm_gates(z, h, ln_scale, ln_bias, eps=eps)
        elif save_z:
            out, z = hafner_cell_cuda(h, x, kernel, bias, ln_scale, ln_bias, eps=eps, save_z=True)
        else:
            return hafner_cell_cuda(h, x, kernel, bias, ln_scale, ln_bias, eps=eps)
        ctx.save_for_backward(h, x, kernel, bias, ln_scale, ln_bias, z)
        return out

    @staticmethod
    def backward(ctx, g):
        h, x, kernel, bias, ln_scale, ln_bias, z = ctx.saved_tensors
        need = ctx.needs_input_grad
        H = h.shape[-1]
        dz, dh, dscale, dlbias = _gates_vjp(z, h, ln_scale, ln_bias, ctx.eps, g)
        dh_out = dx = dkernel = dbias = None
        if need[0] or need[1]:
            du = dz @ kernel.t()
            dh_out, dx = dh + du[:, :H], du[:, H:]
        if need[2]:
            dkernel = torch.cat([h, x], dim=-1).t() @ dz
        if bias is not None and need[3]:
            dbias = dz.sum(dim=0)
        return dh_out, dx, dkernel, dbias, dscale, dlbias, None, None


class _HafnerSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h0, xs, kernel, bias, ln_scale, ln_bias, eps, save_z):
        """``save_z``: keep the steps' pre-activations for the backward (as
        for the cell)."""
        ctx.eps = eps
        if h0.device.type == "cpu":
            hs, z = reference.hafner_sequence_with_z(h0, xs, kernel, bias, ln_scale, ln_bias, eps=eps)
        elif save_z:
            hs, z = hafner_sequence_cuda(h0, xs, kernel, bias, ln_scale, ln_bias, eps=eps, save_z=True)
        else:
            return hafner_sequence_cuda(h0, xs, kernel, bias, ln_scale, ln_bias, eps=eps)
        ctx.save_for_backward(h0, xs, kernel, bias, ln_scale, ln_bias, hs, z)
        return hs

    @staticmethod
    def backward(ctx, g_hs):
        """The cell's VJP in reverse over T at the kept ``z`` (no product
        recomputed); the weight and input products for all T at once, as the
        JAX backward program hoists them (``_xla_sequence_padded``)."""
        h0, xs, kernel, bias, ln_scale, ln_bias, hs, z = ctx.saved_tensors
        T, B, X = xs.shape
        H = h0.shape[-1]
        w_h, w_x = kernel[:H], kernel[H:]
        h_prev = torch.cat([h0[None], hs[:-1]], dim=0)
        dz_all = torch.empty_like(z)
        carry = torch.zeros_like(h0)
        dscale = dlbias = None
        for t in range(T - 1, -1, -1):
            dz, dh, ds, dlb = _gates_vjp(z[t], h_prev[t], ln_scale, ln_bias, ctx.eps, g_hs[t] + carry)
            dz_all[t] = dz
            if ds is not None:
                dscale = ds if dscale is None else dscale + ds
                dlbias = dlb if dlbias is None else dlbias + dlb
            carry = dh + dz @ w_h.t()
        dz_flat = dz_all.reshape(T * B, 3 * H)
        dkernel = torch.cat(
            [h_prev.reshape(T * B, H).t() @ dz_flat, xs.reshape(T * B, X).t() @ dz_flat], dim=0
        )
        dbias = dz_flat.sum(dim=0) if bias is not None else None
        return carry, dz_all @ w_x.t(), dkernel, dbias, dscale, dlbias, None, None


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
    version on CPU tensors; differentiable in all six operands. The
    pre-activation is kept for the backward only when a graph is recorded."""
    save_z = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (h, x, kernel, bias, ln_scale, ln_bias)
    )
    return _HafnerCell.apply(h, x, kernel, bias, ln_scale, ln_bias, float(eps), save_z)


def hafner_gru_sequence(
    h0: torch.Tensor,
    xs: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor],
    ln_scale: Optional[torch.Tensor],
    ln_bias: Optional[torch.Tensor],
    *,
    eps: float,
) -> torch.Tensor:
    """The step over ``xs [T,B,X]`` with h carried from ``h0 [B,H]`` →
    ``hs [T,B,H]``: the CUDA kernel on CUDA tensors (the variant its plan
    picks), the plain loop on CPU tensors; differentiable in all six
    operands. The pre-activations are kept only when a graph is recorded."""
    save_z = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (h0, xs, kernel, bias, ln_scale, ln_bias)
    )
    return _HafnerSequence.apply(h0, xs, kernel, bias, ln_scale, ln_bias, float(eps), save_z)

"""The 3xTF32 product of the CUDA cell, emulated in plain PyTorch on the CPU,
and the cell's VJP at the pre-activation its forward keeps.

The CUDA product (``sheeprl_tpu_torch/kernels/csrc/hafner_gru.cu``) runs on
the tensor cores in TF32. To keep f32 accuracy it rounds each f32 operand v
to ``hi = cvt.rna.tf32.f32(v)`` (10 mantissa bits, to nearest, ties away
from zero), takes ``lo = tf32(v - hi)``, and accumulates ``hi·hi + hi·lo +
lo·hi`` in f32. Here that arithmetic is emulated with integer bit operations
and f32 matmuls (a product of two TF32 values is exact in f32) at the
DreamerV2 width (B=64, K=1000, N=1800), and held against float64:

- three passes agree with float64 within twice the plain f32 product's own
  error (the dropped ``lo·lo`` term and the rounding of ``lo`` are near
  2^-22 of each product);
- one pass is off by hundreds of times that, and the cell built on it
  misses ``TOL_KERNEL`` (1e-4, ``chip_smoke.py``): the reason for three;
- the cell built on three passes agrees with the plain cell and the JAX
  reference cell within ``TOL_KERNEL``.

The emulation sums in f32 with round-to-nearest; the tensor cores' own
accumulation rounding is measured on the card (``PERF.md``), not here.
"""

import numpy as np
import pytest
import torch

from sheeprl_tpu.kernels import reference as jax_reference
from sheeprl_tpu_torch.kernels import ops, reference

TOL_KERNEL = 1e-4


def tf32(v: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: add half a unit of the 13 dropped mantissa bits
    to the magnitude, then drop them (ties away from zero)."""
    return ((v.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def split(v: torch.Tensor):
    hi = tf32(v)
    return hi, tf32(v - hi)


def product_3xtf32(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    (u_hi, u_lo), (w_hi, w_lo) = split(u), split(w)
    return u_hi @ w_hi + u_hi @ w_lo + u_lo @ w_hi


def product_1xtf32(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return tf32(u) @ tf32(w)


def _dv2_operands(seed: int = 0, B: int = 64, H: int = 600, X: int = 400):
    rng = np.random.RandomState(seed)
    h = rng.randn(B, H).astype(np.float32)
    x = rng.randn(B, X).astype(np.float32)
    w = (0.05 * rng.randn(H + X, 3 * H)).astype(np.float32)
    b = (0.1 * rng.randn(3 * H)).astype(np.float32)
    s = (1.0 + 0.1 * rng.randn(3 * H)).astype(np.float32)
    lb = (0.1 * rng.randn(3 * H)).astype(np.float32)
    return h, x, w, b, s, lb


@pytest.mark.parametrize(
    "value,rounded",
    [
        (1 + 2**-11, 1 + 2**-10),  # a tie: away from zero
        (-(1 + 2**-11), -(1 + 2**-10)),
        (1 + 2**-11 - 2**-23, 1.0),  # just below the tie: down
        (1 + 3 * 2**-11, 1 + 2**-9),  # a tie on an odd unit: still away from zero
        (2**-10 * (1 + 2**-12), 2**-10),
    ],
)
def test_tf32_rounds_to_nearest_ties_away(value, rounded):
    assert tf32(torch.tensor([value], dtype=torch.float32)).item() == rounded


def test_tf32_split_is_exact_to_two_units_of_the_22nd_bit():
    v = torch.from_numpy(np.random.RandomState(1).randn(4096).astype(np.float32) * 10.0)
    hi, lo = split(v)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all() and ((lo.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((hi - v).abs() <= 2.0**-11 * v.abs()).all()
    assert ((hi.double() + lo.double() - v.double()).abs() <= 2.0**-21 * v.abs().double()).all()


def test_three_tf32_passes_are_as_accurate_as_the_f32_product():
    h, x, w, *_ = _dv2_operands()
    u, W = torch.cat([torch.from_numpy(h), torch.from_numpy(x)], dim=-1), torch.from_numpy(w)
    truth = u.double() @ W.double()
    err_f32 = ((u @ W).double() - truth).abs().max().item()
    err_3 = (product_3xtf32(u, W).double() - truth).abs().max().item()
    err_1 = (product_1xtf32(u, W).double() - truth).abs().max().item()
    assert err_3 <= 2.0 * err_f32, (err_3, err_f32)
    assert err_1 >= 100.0 * err_3, (err_1, err_3)  # why one pass is not enough


def test_cell_on_three_tf32_passes_matches_the_plain_and_jax_cells():
    h, x, w, b, s, lb = _dv2_operands()
    args = [torch.from_numpy(a) for a in (h, x, w, b, s, lb)]
    u = torch.cat(args[:2], dim=-1)
    plain = reference.hafner_cell(*args, eps=1e-5)
    jax_cell = torch.from_numpy(np.array(jax_reference.hafner_cell(h, x, w, b, s, lb, eps=1e-5), dtype=np.float32))
    three = reference.hafner_norm_gates(product_3xtf32(u, args[2]) + args[3], args[0], args[4], args[5], eps=1e-5)
    one = reference.hafner_norm_gates(product_1xtf32(u, args[2]) + args[3], args[0], args[4], args[5], eps=1e-5)
    assert (three - plain).abs().max().item() <= TOL_KERNEL
    assert (three - jax_cell).abs().max().item() <= TOL_KERNEL
    assert (one - plain).abs().max().item() > TOL_KERNEL  # one pass misses the kernel tolerance


def _recompute_vjp(h, x, kernel, bias, ln_scale, ln_bias, eps, g):
    """The cell's VJP as it was before the forward kept z: recompute
    ``z = [h|x]·W + b``, then the same hand-derived LayerNorm and gate VJP."""
    H = h.shape[-1]
    u = torch.cat([h, x], dim=-1)
    z = u @ kernel
    if bias is not None:
        z = z + bias
    dz, dh, dscale, dlbias = ops._gates_vjp(z, h, ln_scale, ln_bias, eps, g)
    du = dz @ kernel.t()
    grads = [dh + du[:, :H], du[:, H:], u.t() @ dz]
    if bias is not None:
        grads.append(dz.sum(dim=0))
    if ln_scale is not None:
        grads += [dscale, dlbias]
    return grads


@pytest.mark.parametrize("layer_norm", [True, False], ids=["ln", "no_ln"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("H,X", [(600, 400), (599, 37), (1, 37)])
def test_vjp_at_the_saved_z_equals_the_recompute_path(H, X, bias, layer_norm):
    rng = np.random.RandomState(H + X)
    t = lambda *shape, scale=1.0, shift=0.0: torch.from_numpy((shift + scale * rng.randn(*shape)).astype(np.float32))
    operands = [t(5, H), t(5, X), t(H + X, 3 * H, scale=0.1), t(3 * H, scale=0.1) if bias else None,
                t(3 * H, scale=0.1, shift=1.0) if layer_norm else None, t(3 * H, scale=0.1) if layer_norm else None]
    g = t(5, H)
    leaves = [None if a is None else a.clone().requires_grad_(True) for a in operands]
    out = ops.hafner_gru_cell(*leaves, eps=1e-5)
    got = torch.autograd.grad(out, [a for a in leaves if a is not None], g)
    want = _recompute_vjp(*operands, 1e-5, g)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_forward_keeps_z_only_for_a_recorded_graph():
    h, x, w, b, s, lb = (torch.from_numpy(a) for a in _dv2_operands(B=3, H=8, X=4))
    leaves = [a.clone().requires_grad_(True) for a in (h, x, w, b, s, lb)]
    out = ops.hafner_gru_cell(*leaves, eps=1e-5)
    saved = out.grad_fn.saved_tensors
    torch.testing.assert_close(saved[-1], torch.cat([h, x], dim=-1) @ w + b, rtol=0, atol=0)
    with torch.no_grad():
        assert ops.hafner_gru_cell(*leaves, eps=1e-5).grad_fn is None
    assert ops.hafner_gru_cell(h, x, w, b, s, lb, eps=1e-5).grad_fn is None

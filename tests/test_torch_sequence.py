"""The port's LayerNorm-GRU sequence against the JAX package's.

On the CPU the port's ``hafner_gru_sequence`` runs its plain version (the
cell under a loop over T) forward and its hand-derived VJP backward. The
forward is held against ``pallas_tpu.hafner_sequence`` run in interpret
mode, as the JAX package's own kernel tests run it; the gradients against
that kernel's ``jax.custom_vjp`` (the VJP of its padded XLA program).
Inputs are made with numpy from a seed and handed to both sides.

Tolerances, the JAX kernel suite's own (``test_kernels.py:163-237``):
forward rtol 1e-4, atol 1e-5; gradients rtol 2e-4, atol 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.kernels import pallas_tpu
from sheeprl_tpu_torch.kernels import ops, reference

FWD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)


def _operands(T, B, H, X, *, bias=True, layer_norm=True, seed=0):
    rng = np.random.RandomState(seed)
    h0 = rng.randn(B, H).astype(np.float32)
    xs = rng.randn(T, B, X).astype(np.float32)
    kernel = (rng.randn(H + X, 3 * H) * 0.05).astype(np.float32)
    b = (rng.randn(3 * H) * 0.05).astype(np.float32) if bias else None
    s = (1.0 + 0.05 * rng.randn(3 * H)).astype(np.float32) if layer_norm else None
    lb = (0.05 * rng.randn(3 * H)).astype(np.float32) if layer_norm else None
    return h0, xs, kernel, b, s, lb


def _pallas(args, H, eps, layer_norm):
    return pallas_tpu.hafner_sequence(*args, hidden_size=H, eps=eps, layer_norm=layer_norm, interpret=True)


@pytest.mark.parametrize("layer_norm,bias", [(True, True), (False, False)], ids=["ln_bias", "plain"])
@pytest.mark.parametrize("T,B,H,X", [(5, 3, 600, 400), (4, 2, 599, 37), (3, 5, 1, 37)])
def test_plain_sequence_matches_pallas_interpret(T, B, H, X, layer_norm, bias):
    ops_np = _operands(T, B, H, X, bias=bias, layer_norm=layer_norm, seed=T + H + X)
    want = np.asarray(jax.jit(lambda *a: _pallas(a, H, 1e-3, layer_norm))(*ops_np))
    with torch.inference_mode():
        got = ops.hafner_gru_sequence(*[None if a is None else torch.from_numpy(a) for a in ops_np], eps=1e-3)
    assert got.shape == (T, B, H)
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)


@pytest.mark.parametrize("T,B,H,X", [(4, 3, 128, 64), (3, 2, 600, 400), (3, 2, 599, 37), (4, 3, 1, 37)])
def test_sequence_vjp_matches_pallas_custom_vjp(T, B, H, X):
    ops_np = _operands(T, B, H, X, seed=7 + H)

    def loss(*a):
        return jnp.sum(jnp.tanh(_pallas(a, H, 1e-3, True)))

    want = jax.jit(jax.grad(loss, argnums=tuple(range(6))))(*ops_np)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in ops_np]
    got = torch.autograd.grad(torch.tanh(ops.hafner_gru_sequence(*leaves, eps=1e-3)).sum(), leaves)
    for name, g, w in zip(("h0", "xs", "kernel", "bias", "ln_scale", "ln_bias"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL, err_msg=name)


def test_sequence_launches_nothing_on_the_cpu_and_matches_the_cell_loop():
    args = [None if a is None else torch.from_numpy(a) for a in _operands(3, 2, 16, 8)]
    before = ops.hafner_sequence_launches.count
    hs = ops.hafner_gru_sequence(*args, eps=1e-5)
    assert ops.hafner_sequence_launches.count == before
    h = args[0]
    for t in range(3):
        h = reference.hafner_cell(h, args[1][t], *args[2:], eps=1e-5)
        torch.testing.assert_close(hs[t], h, rtol=0, atol=0)


def _recompute_vjp(h0, xs, kernel, bias, ln_scale, ln_bias, eps, g_hs):
    """The sequence's VJP with each step's z recomputed from the saved hs
    (as the plain forward computes it, ``[h|x]·W + b``), then the same
    hand-derived LayerNorm and gate VJP in reverse over T."""
    hs = reference.hafner_sequence(h0, xs, kernel, bias, ln_scale, ln_bias, eps=eps)
    T, B, X = xs.shape
    H = h0.shape[-1]
    w_h, w_x = kernel[:H], kernel[H:]
    h_prev = torch.cat([h0[None], hs[:-1]], dim=0)
    dz_all = torch.empty((T, B, 3 * H))
    carry = torch.zeros_like(h0)
    dscale = dlbias = None
    for t in range(T - 1, -1, -1):
        z = reference.dense_apply(torch.cat([h_prev[t], xs[t]], dim=-1), kernel, bias)
        dz, dh, ds, dlb = ops._gates_vjp(z, h_prev[t], ln_scale, ln_bias, eps, g_hs[t] + carry)
        dz_all[t] = dz
        if ds is not None:
            dscale = ds if dscale is None else dscale + ds
            dlbias = dlb if dlbias is None else dlbias + dlb
        carry = dh + dz @ w_h.t()
    dz_flat = dz_all.reshape(T * B, 3 * H)
    grads = [carry, dz_all @ w_x.t(),
             torch.cat([h_prev.reshape(T * B, H).t() @ dz_flat, xs.reshape(T * B, X).t() @ dz_flat], dim=0)]
    if bias is not None:
        grads.append(dz_flat.sum(dim=0))
    if ln_scale is not None:
        grads += [dscale, dlbias]
    return grads


@pytest.mark.parametrize("layer_norm,bias", [(True, True), (False, False), (True, False)], ids=["ln_bias", "plain", "ln"])
@pytest.mark.parametrize("T,B,H,X", [(4, 3, 600, 400), (3, 2, 599, 37), (4, 3, 1, 37)])
def test_sequence_vjp_at_the_saved_z_equals_the_recompute_path(T, B, H, X, layer_norm, bias):
    args = [None if a is None else torch.from_numpy(a)
            for a in _operands(T, B, H, X, bias=bias, layer_norm=layer_norm, seed=11 + H)]
    g = torch.from_numpy(np.random.RandomState(H).randn(T, B, H).astype(np.float32))
    leaves = [None if a is None else a.clone().requires_grad_(True) for a in args]
    hs = ops.hafner_gru_sequence(*leaves, eps=1e-3)
    got = torch.autograd.grad(hs, [a for a in leaves if a is not None], g)
    want = _recompute_vjp(*args, 1e-3, g)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_sequence_keeps_z_only_for_a_recorded_graph():
    args = [None if a is None else torch.from_numpy(a) for a in _operands(3, 2, 16, 8)]
    leaves = [a.clone().requires_grad_(True) for a in args]
    hs = ops.hafner_gru_sequence(*leaves, eps=1e-5)
    z = hs.grad_fn.saved_tensors[-1]
    h_prev = torch.cat([args[0][None], hs.detach()[:-1]], dim=0)
    want = torch.stack([torch.cat([h_prev[t], args[1][t]], dim=-1) @ args[2] + args[3] for t in range(3)])
    torch.testing.assert_close(z, want, rtol=0, atol=0)
    with torch.no_grad():
        assert ops.hafner_gru_sequence(*leaves, eps=1e-5).grad_fn is None
    assert ops.hafner_gru_sequence(*args, eps=1e-5).grad_fn is None


def test_sequence_cuda_launcher_refuses_cpu_tensors():
    args = [None if a is None else torch.from_numpy(a) for a in _operands(2, 2, 8, 4)]
    with pytest.raises(ValueError, match="CUDA"):
        ops.hafner_sequence_cuda(*args, eps=1e-5)

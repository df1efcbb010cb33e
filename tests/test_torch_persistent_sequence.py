"""The persistent CUDA recurrence of ``hafner_sequence``, emulated in plain
PyTorch on the CPU, against the JAX package's Pallas sequence.

The persistent kernel (``hafner_recurrence_kernel`` in
``sheeprl_tpu_torch/kernels/csrc/hafner_gru.cu``) does arithmetic the plain
loop does not: it splits f32 operands into TF32 hi and lo (3xTF32), sums
four K slices of ``h · W[:H]`` (one block of a cluster each) in rank order,
holds the three gate columns of 21 hidden units in one permuted 64-row tile,
and takes each row's LayerNorm statistics as per-group (mean, M2) partials
merged by Chan et al.'s formula for k groups in the order a warp sums them
(lanes over the groups, then a butterfly). Here that arithmetic is written out in float32 with
torch and held against ``pallas_tpu.hafner_sequence(..., interpret=True)``
at the JAX kernel suite's tolerance (rtol 1e-4, atol 1e-5), at the
DreamerV2 width and at an odd one whose last unit group is part-filled.

The plan's arithmetic (``ops.sequence_shape``, mirrored from the source's
``sequence_shape`` and checked against it on the card) is tested at its
limits; whether every block is co-resident is the card's answer.
"""

import jax
import numpy as np
import pytest
import torch

from sheeprl_tpu.kernels import pallas_tpu
from sheeprl_tpu_torch.kernels import ops

FWD_TOL = dict(rtol=1e-4, atol=1e-5)
UNITS, KSPLIT = 21, 4


def tf32(v: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: round to 10 mantissa bits, ties away from zero."""
    return ((v.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def product_3xtf32(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    u_hi, w_hi = tf32(u), tf32(w)
    u_lo, w_lo = tf32(u - u_hi), tf32(w - w_hi)
    return u_hi @ w_hi + u_hi @ w_lo + u_lo @ w_hi


def tile_features(H: int) -> torch.Tensor:
    """``[groups, 64]`` feature of each tile row (row gate*21 + u is feature
    gate*H + 21*g + u), -1 for the zero rows."""
    groups = -(-H // UNITS)
    feats = torch.full((groups, 64), -1, dtype=torch.long)
    for g in range(groups):
        for gate in range(3):
            for u in range(min(UNITS, H - UNITS * g)):
                feats[g, gate * UNITS + u] = gate * H + UNITS * g + u
    return feats


def warp_sum(lanes):
    """The kernel's ``warp_sum``: an xor butterfly over 32 lane values."""
    for o in (16, 8, 4, 2, 1):
        lanes = [lanes[l] + lanes[l ^ o] for l in range(32)]
    return lanes[0]


def merged_stats(counts, means, m2s):
    """Row mean and M2 from per-group partials ``[B, groups]`` by Chan et
    al.'s formula for k groups, in the warp's order: lane l takes groups l
    and l + 32, ``mean = sum n_g mean_g / N`` and ``M2 = sum [M2_g + n_g
    (mean_g - mean)^2]`` each summed over the lanes by the butterfly."""
    B, groups = means.shape
    zero = torch.zeros(B, dtype=torch.float32)
    lane_groups = [[g for g in (l, l + 32) if g < groups] for l in range(32)]
    n = counts.sum(dim=1)
    sums = [sum((counts[:, g] * means[:, g] for g in gs), zero) for gs in lane_groups]
    mean = warp_sum(sums) / n
    m2 = [sum((m2s[:, g] + counts[:, g] * (means[:, g] - mean) ** 2 for g in gs), zero) for gs in lane_groups]
    return mean, warp_sum(m2)


def emulate_persistent(h0, xs, kernel, bias, ln_scale, ln_bias, eps):
    """``hs [T, B, H]`` by the persistent kernel's arithmetic, in float32."""
    T, B, X = xs.shape
    H = h0.shape[1]
    shape = ops.sequence_shape(B, H)
    kq, groups = shape["k_rows"], shape["unit_groups"]
    steps, warpgroups = kq // 8, shape["warps"] // 4
    feats = tile_features(H)
    valid = feats >= 0
    gather = feats.clamp(min=0)
    w_tile = kernel[:H][:, gather] * valid  # [H, groups, 64]: W[:H]^T's tiles, zero rows zeroed
    zx = product_3xtf32(xs.reshape(T * B, X), kernel[H:]).reshape(T, B, 3 * H) if X else torch.zeros(T, B, 3 * H)
    b_tile = (bias[gather] * valid) if bias is not None else torch.zeros(groups, 64)
    counts = (3 * valid[:, :UNITS].sum(dim=1)).float().expand(B, groups)
    h = h0
    hs = []
    for t in range(T):
        z = torch.zeros(B, groups, 64)
        for q in range(KSPLIT):  # the cluster's partials, in rank order
            part = torch.zeros(B, groups, 64)
            for wg in range(warpgroups):  # a block's warpgroups' shares of its k8 steps, in order
                k_lo = q * kq + 8 * (wg * steps // warpgroups)
                k_hi = min(q * kq + 8 * ((wg + 1) * steps // warpgroups), H)
                ks = slice(k_lo, max(k_lo, k_hi))
                part = part + product_3xtf32(h[:, ks], w_tile[ks].reshape(-1, groups * 64)).reshape(B, groups, 64)
            z = z + part
        z = (z + zx[t][:, gather] * valid + b_tile) * valid
        if ln_scale is not None:
            mean_g = z.sum(dim=-1) / counts
            m2_g = (((z - mean_g[..., None]) * valid) ** 2).sum(dim=-1)
            mean, m2 = merged_stats(counts, mean_g, m2_g)
            rstd = torch.rsqrt(m2 / (3 * H) + eps)
            z = (z - mean[:, None, None]) * rstd[:, None, None] * ln_scale[gather] + ln_bias[gather]
        h_new = torch.empty_like(h)
        for g in range(groups):
            ug = min(UNITS, H - UNITS * g)
            zr, zc, zu = (z[:, g, gate * UNITS : gate * UNITS + ug] for gate in range(3))
            reset = torch.sigmoid(zr)
            cand = torch.tanh(reset * zc)
            update = torch.sigmoid(zu - 1)
            units = slice(UNITS * g, UNITS * g + ug)
            h_new[:, units] = update * cand + (1 - update) * h[:, units]
        h = h_new
        hs.append(h)
    return torch.stack(hs)


def _operands(T, B, H, X, *, bias, layer_norm, seed):
    rng = np.random.RandomState(seed)
    h0 = rng.randn(B, H).astype(np.float32)
    xs = rng.randn(T, B, X).astype(np.float32)
    kernel = (rng.randn(H + X, 3 * H) * 0.05).astype(np.float32)
    b = (rng.randn(3 * H) * 0.05).astype(np.float32) if bias else None
    s = (1.0 + 0.05 * rng.randn(3 * H)).astype(np.float32) if layer_norm else None
    lb = (0.05 * rng.randn(3 * H)).astype(np.float32) if layer_norm else None
    return h0, xs, kernel, b, s, lb


@pytest.mark.parametrize(
    "T,B,H,X,bias,layer_norm",
    [(4, 16, 600, 400, True, True), (4, 5, 599, 37, False, False), (4, 5, 599, 37, True, True)],
    ids=["dv2_width", "odd_plain", "odd_ln_bias"],
)
def test_emulated_persistent_recurrence_matches_pallas_interpret(T, B, H, X, bias, layer_norm):
    ops_np = _operands(T, B, H, X, bias=bias, layer_norm=layer_norm, seed=T + B + H + X)
    want = np.asarray(
        jax.jit(
            lambda *a: pallas_tpu.hafner_sequence(*a, hidden_size=H, eps=1e-3, layer_norm=layer_norm, interpret=True)
        )(*ops_np)
    )
    got = emulate_persistent(*[None if a is None else torch.from_numpy(a) for a in ops_np], eps=1e-3)
    assert got.shape == (T, B, H)
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)


def test_tiles_hold_every_gate_column_once():
    for H in (600, 599, 22, 1):
        feats = tile_features(H)
        real = feats[feats >= 0]
        assert sorted(real.tolist()) == list(range(3 * H))
        assert (feats[:, 63] == -1).all()  # the tile's last row is a zero row
    assert tile_features(599).shape[0] == 29 and (tile_features(599)[-1] >= 0).sum().item() == 3 * 11


def test_chan_merge_of_group_partials_is_the_two_pass_statistics():
    rng = np.random.RandomState(3)
    H, B = 599, 7
    z = torch.from_numpy((2.0 + 3.0 * rng.randn(B, 3 * H)).astype(np.float32))
    feats = tile_features(H)
    valid = feats >= 0
    zt = z[:, feats.clamp(min=0)] * valid
    counts = (3 * valid[:, :UNITS].sum(dim=1)).float().expand(B, -1)
    mean_g = zt.sum(dim=-1) / counts
    m2_g = (((zt - mean_g[..., None]) * valid) ** 2).sum(dim=-1)
    mean, m2 = merged_stats(counts, mean_g, m2_g)
    z64 = z.double()
    assert (counts.sum(dim=1) == 3 * H).all()
    np.testing.assert_allclose(mean.numpy(), z64.mean(dim=-1).numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose((m2 / (3 * H)).numpy(), z64.var(dim=-1, unbiased=False).numpy(), rtol=1e-5)


@pytest.mark.parametrize(
    "B,H,fits,tile_rows,k_rows,groups,smem",
    [
        # K rows a block: ceil(H / 4) rounded up to 8 x the block's warpgroups (2, or 4 at N=64)
        (16, 600, True, 16, 160, 29, 4 * (2 * 64 * 160 + 2 * 16 * 160 + 16 * 68 + 4 * 64 + 8 * 32 + 192)),  # kernel bench
        (5, 599, True, 8, 160, 29, 4 * (2 * 64 * 160 + 2 * 8 * 160 + 8 * 68 + 2 * 64 + 8 * 32 + 192)),
        (64, 600, True, 64, 160, 29, 4 * (2 * 64 * 160 + 2 * 64 * 160 + 64 * 68 + 16 * 64 + 16 * 32 + 192)),
        (65, 600, False, 64, 160, 29, 4 * (2 * 64 * 160 + 2 * 64 * 160 + 64 * 68 + 16 * 64 + 16 * 32 + 192)),  # past N=64
        (16, 2048, False, 16, 512, 98, 4 * (2 * 64 * 512 + 2 * 16 * 512 + 16 * 68 + 4 * 64 + 8 * 32 + 192)),  # W[:H] too large
        (1, 1, True, 8, 16, 1, 4 * (2 * 64 * 16 + 2 * 8 * 16 + 8 * 68 + 2 * 64 + 8 * 32 + 192)),
    ],
)
def test_sequence_shape_limits(B, H, fits, tile_rows, k_rows, groups, smem):
    shape = ops.sequence_shape(B, H)
    assert shape == {"tile_rows": tile_rows, "k_rows": k_rows, "warps": 16 if tile_rows == 64 else 8,
                     "unit_groups": groups, "blocks": 4 * groups, "smem_bytes": smem, "fits": fits}
    assert shape["smem_bytes"] <= 232448 or not shape["fits"]

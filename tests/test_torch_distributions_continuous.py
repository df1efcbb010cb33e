"""The port's continuous distributions against the JAX package's on the CPU.

``Normal``, ``TanhNormal``, ``TruncatedNormal`` and ``Independent`` over each
of them, from the same numpy-seeded parameters: means, modes, ``log_prob``,
``entropy``, the truncated normal's ``cdf`` and ``icdf``, and ``rsample`` at
the same base noise (standard normals, or the uniforms on ``[1e-6, 1 −
1e-6]`` a truncated normal's inverse cdf is drawn at), with its gradients
in ``loc`` and ``scale`` against ``jax.grad`` of the JAX sampler at the noise
that JAX's own key draws (a uniform draw from ``key`` is a pure function of
the key, so the test re-draws it and hands it to the port).

Tolerances (float32; XLA and PyTorch evaluate ``erf``, ``erfinv``, ``log``
and ``tanh`` with different approximations): values rtol 1e-5, atol 1e-6;
the inverse cdf and the samples built on it, and their gradients, rtol 1e-4,
atol 1e-5 (``erfinv`` near ``1 − 1e-6`` has a derivative of ~10^5 in its
argument, so a last-bit difference of ``Φ(α) + p·Z`` moves the sample by
~1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.distributions import distributions as jd
from sheeprl_tpu_torch.distributions import Independent, Normal, TanhNormal, TruncatedNormal, truncated_uniform_noise

VAL_TOL = dict(rtol=1e-5, atol=1e-6)
ICDF_TOL = dict(rtol=1e-4, atol=1e-5)
SHAPE = (5, 7, 6)


def _params(seed=0):
    rng = np.random.RandomState(seed)
    loc = np.tanh(rng.randn(*SHAPE)).astype(np.float32)
    scale = (0.1 + 2.0 / (1.0 + np.exp(-rng.randn(*SHAPE)))).astype(np.float32)
    return loc, scale


def _pair(kind, loc, scale):
    t, j = torch.from_numpy(loc), jnp.asarray(loc)
    ts, js = torch.from_numpy(scale), jnp.asarray(scale)
    if kind == "normal":
        return Normal(t, ts), jd.Normal(j, js)
    if kind == "tanh_normal":
        return TanhNormal(t, ts), jd.TanhNormal(j, js)
    return TruncatedNormal(t, ts, -1.0, 1.0), jd.TruncatedNormal(j, js, -1.0, 1.0)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("kind", ["normal", "tanh_normal", "trunc_normal"])
@pytest.mark.parametrize("independent", [False, True])
def test_mean_mode_log_prob_entropy_match_jax(kind, independent):
    loc, scale = _params(1)
    mine, theirs = _pair(kind, loc, scale)
    if independent:
        mine, theirs = Independent(mine, 1), jd.Independent(theirs, 1)
    np.testing.assert_allclose(_np(mine.mean), _np(theirs.mean), **VAL_TOL)
    np.testing.assert_allclose(_np(mine.mode), _np(theirs.mode), **VAL_TOL)
    rng = np.random.RandomState(2)
    value = np.clip(rng.randn(*SHAPE), -0.999, 0.999).astype(np.float32)
    got, want = _np(mine.log_prob(torch.from_numpy(value))), _np(theirs.log_prob(jnp.asarray(value)))
    assert got.shape == want.shape == (SHAPE[:-1] if independent else SHAPE)
    np.testing.assert_allclose(got, want, **VAL_TOL)
    if kind != "tanh_normal":  # no closed form (the actors report zeros for it)
        np.testing.assert_allclose(_np(mine.entropy()), _np(theirs.entropy()), **VAL_TOL)


def test_truncated_normal_cdf_icdf_and_outside_log_prob_match_jax():
    loc, scale = _params(3)
    mine, theirs = _pair("trunc_normal", loc, scale)
    rng = np.random.RandomState(4)
    value = rng.uniform(-1, 1, SHAPE).astype(np.float32)
    np.testing.assert_allclose(_np(mine.cdf(torch.from_numpy(value))), _np(theirs.cdf(jnp.asarray(value))), **VAL_TOL)
    # the inverse cdf over the sampling range, its ends included
    p = rng.uniform(1e-6, 1 - 1e-6, SHAPE).astype(np.float32)
    p[0, 0] = 1e-6
    p[0, 1] = 1 - 1e-6
    got, want = _np(mine.icdf(torch.from_numpy(p))), _np(theirs.icdf(jnp.asarray(p)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **ICDF_TOL)
    np.testing.assert_allclose(_np(mine.cdf(mine.icdf(torch.from_numpy(p)))), p, rtol=0, atol=2e-4)
    outside = np.where(rng.rand(*SHAPE) < 0.5, 1.5, -1.5).astype(np.float32)
    got = _np(mine.log_prob(torch.from_numpy(outside)))
    assert np.isneginf(got).all() and np.isneginf(_np(theirs.log_prob(jnp.asarray(outside)))).all()
    # Z = Φ(β) − Φ(α) clipped at 1e-8: a scale far below the distance to the bounds
    far = TruncatedNormal(torch.full((3,), 5.0), torch.full((3,), 0.01))
    assert float(far.Z.min()) == pytest.approx(1e-8) and torch.isfinite(far.log_prob(torch.ones(3))).all()


def _jax_sample(kind, loc, scale, key):
    dist = {"normal": jd.Normal, "tanh_normal": jd.TanhNormal}.get(kind)
    if dist is None:
        return jd.TruncatedNormal(loc, scale, -1.0, 1.0).rsample(key)
    return dist(loc, scale).rsample(key)


def _jax_noise(kind, key):
    if kind == "trunc_normal":
        return np.array(jax.random.uniform(key, SHAPE, minval=1e-6, maxval=1 - 1e-6))
    return np.array(jax.random.normal(key, SHAPE))


@pytest.mark.parametrize("kind", ["normal", "tanh_normal", "trunc_normal"])
def test_rsample_and_its_gradients_match_jax(kind):
    """The sample at JAX's own noise, and the gradient of ``Σ w·sample`` in
    ``loc`` and ``scale`` against ``jax.grad`` of the JAX sampler."""
    loc, scale = _params(5)
    w = np.random.RandomState(6).randn(*SHAPE).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = np.asarray(_jax_sample(kind, jnp.asarray(loc), jnp.asarray(scale), key))
    j_grads = jax.grad(lambda l, s: jnp.sum(jnp.asarray(w) * _jax_sample(kind, l, s, key)), argnums=(0, 1))(
        jnp.asarray(loc), jnp.asarray(scale)
    )

    t_loc, t_scale = (torch.from_numpy(a).requires_grad_(True) for a in (loc, scale))
    mine = Independent(_pair(kind, loc, scale)[0].__class__(t_loc, t_scale), 1)
    sample = mine.rsample(noise=torch.from_numpy(_jax_noise(kind, key)))
    np.testing.assert_allclose(_np(sample), want, **ICDF_TOL)
    (torch.from_numpy(w) * sample).sum().backward()
    np.testing.assert_allclose(t_loc.grad.numpy(), np.asarray(j_grads[0]), **ICDF_TOL, err_msg="d loc")
    np.testing.assert_allclose(t_scale.grad.numpy(), np.asarray(j_grads[1]), **ICDF_TOL, err_msg="d scale")
    assert torch.equal(mine.sample(noise=torch.from_numpy(_jax_noise(kind, key))), sample.detach())


def test_drawn_noise_has_the_samplers_shapes_and_ranges():
    loc, scale = (torch.from_numpy(a) for a in _params(8))
    gen = torch.Generator().manual_seed(0)
    u = truncated_uniform_noise((100,) + SHAPE, gen)
    assert u.shape == (100,) + SHAPE and float(u.min()) >= 1e-6 and float(u.max()) <= 1 - 1e-6
    trunc = Independent(TruncatedNormal(loc, scale), 1)
    assert trunc.base.draw_noise((3,), gen).shape == (3,) + SHAPE
    s = trunc.sample((100,), gen)
    assert s.shape == (100,) + SHAPE and float(s.min()) >= -1.0 and float(s.max()) <= 1.0
    assert Normal(loc, scale).rsample(generator=gen).shape == SHAPE
    # a float scale stays on the host and broadcasts
    assert Normal(loc, 1.0).entropy().shape == SHAPE

"""The port's A2C against the JAX package on the CPU: its losses, and one
whole update (one pass over the JAX update's own permutation, 2
minibatches) from the same weights and rollout. A2C's agent is PPO's
(``tests/test_torch_ppo.py`` holds it). Tolerances as that file's: losses
atol 1e-5; the update's mean losses within 1e-5 relative, Adam's moments
within 1e-5 relative (L2, the second in the gradient's units), parameters
within 1e-5 relative (L2; ``2·lr`` a step where the JAX first moment lies
within 1e-7 of zero)."""

from __future__ import annotations

import jax
import numpy as np
import pytest

from sheeprl_tpu.algos.a2c import a2c as jax_a2c
from sheeprl_tpu.algos.a2c import loss as jax_loss
from sheeprl_tpu_torch.algos.a2c import loss as port_loss
from sheeprl_tpu_torch.algos.a2c.a2c import a2c_loss
from sheeprl_tpu_torch.algos.ppo.ppo import UpdateProgram, build_optimizer, select_rows
from sheeprl_tpu_torch.config import compose
from test_torch_ppo import ACTIONS, BS, N_LOCAL, OBS_KINDS, OUT_TOL, _t, agents, check_update, jax_update, \
    rollout_batch, update_overrides


@pytest.fixture(autouse=True, scope="module")
def restore_prng_impl():
    """The JAX Fabric switches JAX's default key implementation for the
    whole process (to ``rbg``): put it back after the module, so that a
    later file on the same worker draws the keys it expects."""
    saved = jax.config.jax_default_prng_impl
    yield
    jax.config.update("jax_default_prng_impl", saved)


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_losses_match_jax(reduction):
    rng = np.random.RandomState(6)
    lp, adv, values, returns = (rng.randn(16, 1).astype(np.float32) for _ in range(4))
    np.testing.assert_allclose(port_loss.policy_loss(_t(lp), _t(adv), reduction).numpy(),
                               np.asarray(jax_loss.policy_loss(lp, adv, reduction)), **OUT_TOL)
    np.testing.assert_allclose(port_loss.value_loss(_t(values), _t(returns), reduction).numpy(),
                               np.asarray(jax_loss.value_loss(values, returns, reduction)), **OUT_TOL)


@pytest.mark.parametrize("kind,action,extra", [
    ("mlp", "discrete", ("algo.ent_coef=0.01",)),
    ("mlp", "continuous", ("algo.normalize_advantages=True", "algo.max_grad_norm=0.5")),
    ("pixels_and_mlp", "multidiscrete", ()),
])
def test_update_matches_jax(kind, action, extra):
    """One whole A2C update at the JAX update's own permutation: the mean
    losses, then every parameter and Adam moment."""
    j, params, port = agents(kind, action, key=3)
    overrides = update_overrides(kind, extra)
    data = rollout_batch(8, kind, action)
    data.pop("logprobs")
    jax_data = {k: v for k, v in data.items() if k != "values"}
    new_params, new_opt, j_metrics, perms = jax_update("a2c", overrides, j, params, jax_data, key=10,
                                                       update_fn_builder=jax_a2c.build_update_fn)
    cfg = compose(overrides=["exp=a2c"] + overrides)
    actions_dim, is_continuous = ACTIONS[action]
    cnn, mlp = OBS_KINDS[kind]
    optimizer = build_optimizer(cfg, port)
    program = UpdateProgram(a2c_loss(cfg, list(cnn), list(mlp) + list(cnn), actions_dim, is_continuous), select_rows,
                            port, optimizer, max_grad_norm=float(cfg.algo.max_grad_norm or 0.0), epochs=1,
                            n_samples=N_LOCAL, batch_size=BS, n_metrics=2, n_scalars=2, generator=None, device="cpu")
    metrics = program.update(jax_data, [0.0, 0.0], perms=perms)
    np.testing.assert_allclose(metrics.numpy(), j_metrics, rtol=1e-5, atol=1e-7)
    check_update(port, optimizer, new_params, new_opt, float(cfg.algo.optimizer.lr), N_LOCAL // BS)


def test_preset_update_is_one_minibatch_step():
    """The preset's 5-step rollout of 4 envs with a batch of 64: one
    minibatch step of all 20 samples an update (the JAX ``bs = min(64, 20)``)."""
    cfg = compose(overrides=["exp=a2c"])
    j, params, port = agents("mlp", "discrete")
    n = int(cfg.algo.rollout_steps) * int(cfg.env.num_envs)
    program = UpdateProgram(a2c_loss(cfg, [], ["state"], (3,), False), select_rows, port, build_optimizer(cfg, port),
                            max_grad_norm=0.0, epochs=1, n_samples=n, batch_size=int(cfg.per_rank_batch_size),
                            n_metrics=2, n_scalars=2, generator=None, device="cpu")
    assert (n, program.batch_size, program.n_minibatches) == (20, 20, 1)
    del j, params

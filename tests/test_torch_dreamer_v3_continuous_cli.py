"""A JAX continuous-action DreamerV3 checkpoint served by the port on the CPU.

A tiny JAX DreamerV3 CLI dry run on the continuous dummy env (a 2-wide Box
of actions) writes a checkpoint; the port's ``load_gateway_model(...,
device="cpu")`` serves it with the float action vectors the JAX package's
``load_gateway_model`` serves for the same observations and the same
injected noise (the posterior's Gumbels and the actor's uniforms on ``[1e-6,
1 − 1e-6]``: DreamerV3's policy samples its action at zero exploration).
Three chained steps; actions rtol 1e-4, atol 1e-5 (the truncated normal's
inverse cdf), recurrent and stochastic states within atol 1e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sheeprl_tpu import cli as jax_cli
from sheeprl_tpu.algos.dreamer_v3 import agent as jax_agent
from sheeprl_tpu.serve.model import load_gateway_model as jax_load_gateway_model
from sheeprl_tpu_torch.serve.model import load_gateway_model

S = D = 4
SAMPLE_TOL = dict(rtol=1e-4, atol=1e-5)
ROWS, STEPS = 3, 3


def _jax_continuous_checkpoint(root):
    cwd = os.getcwd()
    os.chdir(root)
    try:
        jax_cli.run([
            "exp=dreamer_v3", "env=dummy", "env.id=continuous_dummy", "env.sync_env=True", "env.num_envs=2",
            "env.capture_video=False", "checkpoint.every=1000000", "metric.log_every=1000000", "metric.log_level=0",
            "buffer.memmap=False", f"root_dir={root / 'logs'}", "run_name=jax", "dry_run=True",
            "per_rank_batch_size=2", "per_rank_sequence_length=1", "algo.learning_starts=0", "algo.horizon=4",
            "algo.dense_units=8", "algo.mlp_layers=1", "algo.world_model.encoder.cnn_channels_multiplier=2",
            "algo.world_model.recurrent_model.recurrent_state_size=8",
            "algo.world_model.transition_model.hidden_size=8",
            "algo.world_model.representation_model.hidden_size=8", f"algo.world_model.stochastic_size={S}",
            f"algo.world_model.discrete_size={D}", "cnn_keys.encoder=[rgb]",
        ])
    finally:
        os.chdir(cwd)
    found = sorted((root / "logs").rglob("ckpt_*_0"))
    assert len(found) == 1, found
    return str(found[0])


def test_a_jax_continuous_checkpoint_serves_the_jax_actions(tmp_path, monkeypatch):
    """DreamerV3's policy samples its action at zero exploration: the same
    posterior Gumbels and action uniforms injected on both sides give the
    same float action vectors and states over three chained steps."""
    ckpt = _jax_continuous_checkpoint(tmp_path)
    rng = np.random.RandomState(0)
    post_noise = rng.gumbel(size=(ROWS, S, D)).astype(np.float32)
    uniforms = rng.uniform(1e-6, 1 - 1e-6, (ROWS, 2)).astype(np.float32)
    frames = [rng.randint(0, 256, (ROWS, 3, 64, 64)).astype(np.uint8) for _ in range(STEPS)]
    sample_state, sample_actions = jax_agent.compute_stochastic_state, jax_agent.sample_actor_actions

    def injected_state(logits, discrete, key, sample=True, gumbel=None):
        if sample and logits.shape[0] == ROWS:
            gumbel = jnp.asarray(post_noise)
        return sample_state(logits, discrete, key, sample, gumbel=gumbel)

    def injected_actions(dists, is_continuous, key, is_training=True):
        if not is_training:
            return sample_actions(dists, is_continuous, key, is_training)
        return [jnp.clip(d.base.icdf(jnp.asarray(uniforms)), -1.0, 1.0) for d in dists]

    monkeypatch.setattr(jax_agent, "compute_stochastic_state", injected_state)
    monkeypatch.setattr(jax_agent, "sample_actor_actions", injected_actions)
    jax_model, *_ = jax_load_gateway_model(ckpt)
    model, _cfg, _obs_space, action_space = load_gateway_model(ckpt, device="cpu")
    assert action_space.shape == (2,) and model.algo == "dreamer_v3"
    jax_state, state = jax_model.init_state_rows(ROWS), model.init_state_rows(ROWS)
    for obs in frames:
        jax_actions, jax_state = jax_model.act({"rgb": obs}, jax_state, jax.random.PRNGKey(0))
        actions, state = model.policy.act({"rgb": obs}, state, None, gumbel=torch.from_numpy(post_noise),
                                          action_gumbels=[torch.from_numpy(uniforms)])
        assert actions.dtype == np.float32 and actions.shape == (ROWS, 2)
        np.testing.assert_allclose(actions, np.asarray(jax_actions), **SAMPLE_TOL)
        np.testing.assert_allclose(state["recurrent"].numpy(), np.asarray(jax_state["recurrent"]), atol=1e-4, rtol=0)
        np.testing.assert_allclose(state["stochastic"].numpy(), np.asarray(jax_state["stochastic"]), atol=1e-4,
                                   rtol=0)

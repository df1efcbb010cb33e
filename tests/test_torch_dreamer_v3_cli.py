"""The port's DreamerV3 run and checkpoint serving on the CPU.

- A tiny JAX DreamerV3 CLI dry run (the argument list of
  ``tests/test_algos/test_dreamer_v3.py``) writes a checkpoint; the port's
  ``load_gateway_model(..., device="cpu")`` serves it with the actions the
  JAX package's ``load_gateway_model`` serves for the same observations and
  the same pre-drawn noise injected on both sides (the posterior's and the
  action's Gumbels: DreamerV3's policy samples its action at zero
  exploration). Three chained steps; recurrent and stochastic state within
  atol 1e-4, sampled categories and actions equal.
- The port's own CLI, ``exp=dreamer_v3`` at a tiny width on the dummy env
  with ``fabric.accelerator=cpu``: it takes gradient steps that move the
  weights, writes a checkpoint the JAX package deep-validates (with the
  sequential buffer), resumes from it, and ``load_gateway_model`` serves it.
"""

import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax_cli_switches import run_jax_cli
import torch

from sheeprl_tpu.algos.dreamer_v3 import agent as jax_agent
from sheeprl_tpu.ckpt import validate_checkpoint as jax_validate_checkpoint
from sheeprl_tpu.serve.model import load_gateway_model as jax_load_gateway_model
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
from sheeprl_tpu_torch.ckpt import read_checkpoint
from sheeprl_tpu_torch.serve.model import load_gateway_model

S = D = 4  # the tiny run's stochastic and discrete sizes
ROWS, STEPS = 3, 3


def tiny_args(root, run_name, extra=()):
    return [
        "env=dummy",
        "env.sync_env=True",
        "checkpoint.every=1000000",
        "metric.log_every=1000000",
        "metric.log_level=0",
        "env.capture_video=False",
        "buffer.memmap=False",
        "env.num_envs=2",
        f"root_dir={root}",
        f"run_name={run_name}",
        "exp=dreamer_v3",
        "per_rank_batch_size=2",
        "algo.horizon=4",
        "algo.dense_units=8",
        "algo.mlp_layers=1",
        "algo.world_model.encoder.cnn_channels_multiplier=2",
        "algo.world_model.recurrent_model.recurrent_state_size=8",
        "algo.world_model.transition_model.hidden_size=8",
        "algo.world_model.representation_model.hidden_size=8",
        f"algo.world_model.stochastic_size={S}",
        f"algo.world_model.discrete_size={D}",
        "cnn_keys.encoder=[rgb]",
        "env.id=discrete_dummy",
        *extra,
    ]


def _checkpoint(root):
    found = sorted(Path(root).rglob("ckpt_*_0"))
    assert len(found) == 1, found
    return str(found[0])


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """One tiny JAX DreamerV3 dry run; returns its checkpoint directory."""
    root = tmp_path_factory.mktemp("jax_dv3")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        run_jax_cli(tiny_args(root / "logs", "jax", ["dry_run=True", "per_rank_sequence_length=1",
                                                     "algo.learning_starts=0"]))
    finally:
        os.chdir(cwd)
    return _checkpoint(root / "logs")


def test_a_jax_checkpoint_serves_the_jax_actions(jax_run, monkeypatch):
    rng = np.random.RandomState(0)
    noise = rng.gumbel(size=(ROWS, S, D)).astype(np.float32)
    action_noise = rng.gumbel(size=(ROWS, 2)).astype(np.float32)
    frames = [rng.randint(0, 256, (ROWS, 3, 64, 64)).astype(np.uint8) for _ in range(STEPS)]

    # the JAX policy samples its posterior and its action inside a jitted step: inject the same noise
    # there (the served batches have ROWS rows; the fresh state's prior mode samples nothing)
    sample_state, sample_actions = jax_agent.compute_stochastic_state, jax_agent.sample_actor_actions

    def injected_state(logits, discrete, key, sample=True, gumbel=None):
        if sample and logits.shape[0] == ROWS:
            gumbel = jnp.asarray(noise)
        return sample_state(logits, discrete, key, sample, gumbel=gumbel)

    def injected_actions(dists, is_continuous, key, is_training=True):
        if not is_training:
            return sample_actions(dists, is_continuous, key, is_training)
        out = []
        for d in dists:
            one = jax.nn.one_hot(jnp.argmax(d.logits + jnp.asarray(action_noise), -1), d.logits.shape[-1])
            out.append(one + d.probs - jax.lax.stop_gradient(d.probs))
        return out

    monkeypatch.setattr(jax_agent, "compute_stochastic_state", injected_state)
    monkeypatch.setattr(jax_agent, "sample_actor_actions", injected_actions)
    jax_model, *_ = jax_load_gateway_model(jax_run)
    model, cfg, observation_space, action_space = load_gateway_model(jax_run, device="cpu")
    assert (model.version, model.algo, model.env_id) == (jax_model.version, "dreamer_v3", "discrete_dummy")
    assert action_space.n == 2 and observation_space["rgb"].shape == (3, 64, 64)

    jax_state, state = jax_model.init_state_rows(ROWS), model.init_state_rows(ROWS)
    np.testing.assert_allclose(state["stochastic"].numpy(), np.asarray(jax_state["stochastic"]), atol=1e-6, rtol=0)
    for obs in frames:
        jax_actions, jax_state = jax_model.act({"rgb": obs}, jax_state, jax.random.PRNGKey(0))
        actions, state = model.policy.act(
            {"rgb": obs}, state, None, gumbel=torch.from_numpy(noise), action_gumbels=[torch.from_numpy(action_noise)]
        )
        np.testing.assert_array_equal(actions, np.asarray(jax_actions))
        np.testing.assert_allclose(state["recurrent"].numpy(), np.asarray(jax_state["recurrent"]), atol=1e-4, rtol=0)
        stochastic, jax_stochastic = state["stochastic"].numpy(), np.asarray(jax_state["stochastic"])
        np.testing.assert_allclose(stochastic, jax_stochastic, atol=1e-4, rtol=0)
        np.testing.assert_array_equal(
            stochastic.reshape(ROWS, S, D).argmax(-1), jax_stochastic.reshape(ROWS, S, D).argmax(-1)
        )


def test_the_port_cli_trains_checkpoints_resumes_and_serves(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    run = ["total_steps=48", "algo.learning_starts=16", "algo.train_every=2", "per_rank_sequence_length=4",
           "buffer.size=200", "buffer.checkpoint=True", "fabric.accelerator=cpu"]
    result = cli.run(tiny_args(tmp_path / "logs", "port", run))
    assert (result["updates"], result["random_steps"], result["player_steps"]) == (24, 8, 16)
    assert result["gradient_steps"] == 17 and result["test_steps"] > 0  # one a update from update 8
    ckpt = result["checkpoint"]
    manifest = jax_validate_checkpoint(ckpt, deep=True)
    assert manifest["framework"] == "torch" and manifest["algo"] == "dreamer_v3"
    state = read_checkpoint(ckpt)
    assert set(state["agent"]) == {"world_model", "actor", "critic", "target_critic", "opt", "moments"}
    assert "rb" in state and float(state["agent"]["moments"]["high"]) != 0.0

    # the gradient steps moved the weights off the seeded initialization; all but the prior's: at this
    # width the KL stays under the free nat, so the clamp gives the transition model no gradient
    cfg, _ = cli.load_run_config(ckpt)
    fresh, _ = build_agent(cfg, (2,), False, {"rgb": (3, 64, 64)}, device="cpu")
    still = {k for k, v in fresh.state_dict().items() if np.array_equal(v.numpy(), state["agent"]["world_model"][k])}
    assert still and all(k.startswith("rssm.transition_model.") for k in still)

    resumed = cli.run(tiny_args(tmp_path / "logs", "resumed", run + [f"checkpoint.resume_from={ckpt}"]))
    # the JAX loop's resume: it starts again at the checkpoint's update (24 of 24), acting and training once
    assert (resumed["updates"], resumed["player_steps"], resumed["random_steps"], resumed["gradient_steps"]) == (
        1, 1, 0, 1)
    assert resumed["checkpoint"].endswith("ckpt_50_0")
    resumed = cli.run(
        tiny_args(tmp_path / "logs", "resumed2", run[1:] + ["total_steps=56", f"checkpoint.resume_from={ckpt}"])
    )
    assert (resumed["updates"], resumed["player_steps"], resumed["gradient_steps"]) == (5, 5, 5)
    assert resumed["checkpoint"].endswith("ckpt_58_0")

    model, *_ = load_gateway_model(ckpt, device="cpu")
    actions, served = model.act({"rgb": np.zeros((2, 3, 64, 64), np.uint8)}, model.init_state_rows(2),
                                torch.Generator().manual_seed(0))
    assert actions.shape == (2, 1) and set(actions.ravel()) <= {0, 1}
    assert torch.isfinite(served["recurrent"]).all()


@pytest.mark.parametrize(
    "overrides,match",
    [
        (["parallel.model_axis=2"], "item 7"),
        (["env.act_burst=4"], "act_burst"),
        # the profiler and the learn probes run now (6h-b, 6h-c); values no run can honour still raise
        (["metric.telemetry.profile.every_n_steps=-1"], "every_n_steps must be >= 0"),
        (["metric.telemetry.enabled=true", "metric.telemetry.learn.every_n_bursts=0"], "every_n_bursts must be >= 1"),
        # the MineDojo actor is ported: it acts on the MineDojo wrapper's masks, which env=dummy does not give
        (["algo.actor.cls=sheeprl_tpu.algos.dreamer_v3.minedojo_actor.MinedojoActor"], "MineDojo wrapper's masks"),
        (["algo.actor.cls=sheeprl_tpu.algos.dreamer_v3.agent.NotAnActor"], "not in the port"),
        (["algo.actor.cls=sheeprl_tpu_torch.algos.dreamer_v3.agent.MLPWithHead"], "only the discrete Actor"),
        (["algo.actor.cls=other.Actor"], "only its own"),
    ],
)
def test_the_run_raises_for_layers_not_ported(tmp_path, monkeypatch, overrides, match):
    """Options whose layers the port does not have, or values no run can
    honour, raise before the run starts, naming what is missing; the actor class resolves in the port
    only (a JAX run's ``sheeprl_tpu.`` path names the port's module)."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises((NotImplementedError, ValueError), match=match):
        cli.run(tiny_args(tmp_path / "logs", "raises", ["dry_run=True", "fabric.accelerator=cpu", *overrides]))

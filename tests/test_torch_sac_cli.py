"""The port's SAC, DroQ and SAC-AE runs through its CLI on the CPU, at a
tiny width: Pendulum through gymnasium for the vector families, the
continuous dummy env's pixels (three frames stacked) for SAC-AE, and the
port's own device Pendulum (``env.backend=jax``, the rollout engine and the
device ring).

- Each run's counters follow the loop's arithmetic: the random updates up
  to ``learning_starts``, SAC's catch-up burst, DroQ's G critic steps and
  one actor step an update, SAC-AE's EMA, actor and decoder cadences, the
  engine's bursts clamped at ``learning_starts``.
- Each checkpoint holds the JAX tree's entries and resumes; the
  ``evaluation`` command scores it.
- A JAX-package checkpoint of each family (a JAX dry run) is served by the
  port: its greedy actions against the JAX package's eval policy on the
  same observations, within 1e-5 (float32 forward passes of each side).
- Without a card and without ``fabric.accelerator=cpu`` each entrypoint
  raises; the options the port does not have raise naming why.
"""

from __future__ import annotations

import glob
import os

import gymnasium as gym
import jax
import numpy as np
import pytest
from jax_cli_switches import run_jax_cli
import torch

from sheeprl_tpu.ckpt.resume import read_checkpoint as jax_read_checkpoint
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.ckpt import read_checkpoint, validate_checkpoint
from sheeprl_tpu_torch.serve.model import load_gateway_model
from test_torch_sac import restore_prng_impl  # noqa: F401  (a module fixture: the JAX CLI's Fabric)

PENDULUM = ["env=gym", "env.id=Pendulum-v1", "env.sync_env=True", "env.capture_video=False", "env.num_envs=2",
            "buffer.memmap=False", "buffer.size=64", "metric.log_level=0", "algo.hidden_size=8",
            "per_rank_batch_size=4", "mlp_keys.encoder=[state]"]
PIXELS = ["env=dummy", "env.id=continuous_dummy", "env.sync_env=True", "env.capture_video=False", "env.num_envs=2",
          "env.frame_stack=3", "buffer.memmap=False", "buffer.size=32", "metric.log_level=0", "algo.hidden_size=8",
          "algo.dense_units=8", "algo.encoder.features_dim=8", "algo.cnn_channels_multiplier=1",
          "per_rank_batch_size=2", "cnn_keys.encoder=[rgb]", "cnn_keys.decoder=[rgb]", "mlp_keys.encoder=[]",
          "mlp_keys.decoder=[]"]
CKPT_KEYS = {"agent", "opt_states", "update", "batch_size", "last_log", "last_checkpoint"}


def _run(tmp_path, exp, base, extra, name):
    return cli.run(base + [f"exp={exp}", "fabric.accelerator=cpu", f"root_dir={tmp_path}/logs", f"run_name={name}"]
                   + extra)


def _check_checkpoint(result, agent_trees, opt_names):
    ckpt = result["checkpoint"]
    assert validate_checkpoint(ckpt, deep=True)["framework"] == "torch"
    state = read_checkpoint(ckpt, with_rb=False)
    assert CKPT_KEYS <= set(state) and set(state["agent"]) == set(agent_trees) | {"log_alpha"}
    assert set(state["opt_states"]) == set(opt_names)
    return state


def _evaluate(ckpt):
    result = cli.evaluation([f"checkpoint_path={ckpt}", "fabric.accelerator=cpu", "eval.episodes=2",
                             "eval.write_registry=False"])
    assert result["n"] == 2 and np.isfinite(result["mean"])
    return result


def test_sac_trains_checkpoints_resumes_and_evaluates(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    run = ["total_steps=24", "algo.learning_starts=8", "algo.per_rank_gradient_steps=2", "checkpoint.every=12"]
    result = _run(tmp_path, "sac", PENDULUM, run, "sac")
    # 12 updates of 2 envs: 4 random; from update 4 on 2 gradient steps an update, the first adding the catch-up
    # of 3 updates' steps: (9 + 3)·2
    assert (result["updates"], result["random_steps"], result["player_steps"]) == (12, 4, 8)
    assert result["gradient_steps"] == 24 and result["ema_steps"] == 24 and result["train_bursts"] == 9
    assert result["graphs"]["train"]["eager_calls"] == 24 and result["graphs"]["act"]["eager_calls"] == 8
    state = _check_checkpoint(result, ("actor", "critics", "target_critics"), ("actor", "qf", "alpha"))
    assert state["agent"]["critics"]["blocks.0.linear.weight"].shape == (2, 4, 8)  # [N, in, out]
    assert state["agent"]["critics"]["blocks.0.linear.weight"].dtype == np.float32
    resumed = _run(tmp_path, "sac", PENDULUM, run + [f"checkpoint.resume_from={result['checkpoint']}",
                                                     "total_steps=32"], "sac_resumed")
    # resumed at update 12 (updates 12..16 run): learning_starts moves past it (no buffer in the checkpoint), so
    # every update is random and the last one, update 16, runs the catch-up burst of 16 updates' steps
    assert (resumed["updates"], resumed["random_steps"], resumed["learning_starts"]) == (5, 5, 16)
    assert resumed["gradient_steps"] == 32
    _evaluate(resumed["checkpoint"])


def test_droq_trains_and_evaluates(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    result = _run(tmp_path, "droq", PENDULUM, ["total_steps=16", "algo.learning_starts=4",
                                               "algo.per_rank_gradient_steps=3", "checkpoint.every=16"], "droq")
    # 8 updates, 2 random; no catch-up: each later update runs G = 3 critic steps and one actor step
    assert (result["updates"], result["random_steps"]) == (8, 2)
    assert (result["gradient_steps"], result["actor_steps"], result["train_bursts"]) == (18, 6, 6)
    assert result["graphs"]["train"]["eager_calls"] == 6
    state = _check_checkpoint(result, ("actor", "critics", "target_critics"), ("actor", "qf", "alpha"))
    assert "blocks.1.norm.weight" in state["agent"]["critics"]
    _evaluate(result["checkpoint"])


def test_sac_ae_trains_stacked_frames_resumes_and_evaluates(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    run = ["total_steps=20", "algo.learning_starts=6", "checkpoint.every=20", "algo.critic.target_network_frequency=2",
           "algo.actor.network_frequency=4", "algo.decoder.update_freq=2", "buffer.checkpoint=True"]
    result = _run(tmp_path, "sac_ae", PIXELS, run, "sac_ae")
    # 10 updates, learning_starts 3: updates 1..3 random; update 3 trains 3 steps (the catch-up), updates 4..10 one
    # each; the cadences every 2, 3 and 2 updates (frequency // n_envs + 1) over updates 3..10
    assert (result["updates"], result["random_steps"], result["gradient_steps"]) == (10, 3, 10)
    assert (result["ema_steps"], result["actor_steps"], result["decoder_steps"]) == (4, 5, 4)
    state = _check_checkpoint(result, ("encoder", "target_encoder", "qfs", "target_qfs", "actor", "decoder"),
                              ("qf", "actor", "alpha", "encoder", "decoder"))
    assert state["agent"]["encoder"]["cnn_encoder.cnn.convs.0.weight"].shape == (32, 9, 3, 3)  # 3 frames × RGB
    resumed = _run(tmp_path, "sac_ae", PIXELS, run + [f"checkpoint.resume_from={result['checkpoint']}",
                                                      "total_steps=24"], "sac_ae_resumed")
    assert resumed["random_steps"] == 0 and resumed["gradient_steps"] == 3  # the buffer came back: no new prefill
    _evaluate(result["checkpoint"])


def test_the_device_backend_collects_on_the_engine_into_the_ring(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    run = ["env.backend=jax", "env.act_burst=4", "total_steps=24", "algo.learning_starts=4", "checkpoint.every=24",
           "buffer.checkpoint=True"]
    with pytest.warns(UserWarning, match="device ring"):
        result = _run(tmp_path, "sac", PENDULUM, run, "jaxb")
    # 12 updates: a random burst of 2 (clamped at learning_starts), then policy bursts of 4, 4, 2
    engine = result["engine"]
    assert (engine["bursts"], engine["env_steps"], result["random_steps"], result["player_steps"]) == (4, 24, 2, 10)
    assert engine["graphs"]["eager_calls"] == 4 and result["graphs"]["act"]["eager_calls"] == 0
    assert (engine["ring_rows"], engine["ring_full"]) == (12, False)
    # the random burst ends at learning_starts (update 2) and trains its catch-up, 2 updates' steps; then 4, 4, 2
    assert result["gradient_steps"] == 12 and result["train_bursts"] == 4 and result["test_steps"] == 200
    state = read_checkpoint(result["checkpoint"])
    np.testing.assert_array_equal(state["rb"]["buffer"]["observations"][:12].shape, (12, 2, 3))
    assert np.abs(state["rb"]["buffer"]["observations"][:12]).sum() > 0 and int(state["rb"]["pos"]) == 12
    resumed = _run(tmp_path, "sac", PENDULUM, run + [f"checkpoint.resume_from={result['checkpoint']}",
                                                     "total_steps=32"], "jaxb_resumed")
    # updates 12..16 (the resume runs its checkpoint's update again, as the JAX loop does) onto the restored ring
    assert resumed["engine"]["ring_rows"] == 17 and resumed["random_steps"] == 0
    _evaluate(result["checkpoint"])  # the gymnasium Pendulum of the same id scores it


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Tiny JAX dry runs of each family; their checkpoint directories. The
    JAX CLI turns its aggregator and timer off for ``metric.log_level=0``
    and leaves them so: they are put back for the tests that follow."""
    from sheeprl_tpu.utils.metric import MetricAggregator
    from sheeprl_tpu.utils.timer import timer

    root = tmp_path_factory.mktemp("jax_sac")
    cwd = os.getcwd()
    os.chdir(root)
    saved = MetricAggregator.disabled, timer.disabled
    runs = {}
    try:
        for exp, base in (("sac", PENDULUM), ("droq", PENDULUM), ("sac_ae", PIXELS)):
            run_jax_cli(base + [f"exp={exp}", "fabric.accelerator=cpu", "dry_run=True", "algo.learning_starts=0",
                                "algo.run_test=False", f"root_dir={root}/logs", f"run_name={exp}"])
            runs[exp] = sorted(glob.glob(f"{root}/logs/**/{exp}/**/ckpt_*_0", recursive=True))[-1]
    finally:
        os.chdir(cwd)
        MetricAggregator.disabled, timer.disabled = saved
    return runs


@pytest.mark.parametrize("exp", ["sac", "droq", "sac_ae"])
def test_a_jax_checkpoint_is_served_and_evaluated_by_the_port(jax_runs, exp):
    from sheeprl_tpu.evals.service import find_eval_builder as jax_find_eval_builder

    import sheeprl_tpu.algos.sac.evaluate  # noqa: F401  (registers the JAX builders)
    import sheeprl_tpu.algos.sac_ae.evaluate  # noqa: F401

    ckpt = jax_runs[exp]
    model, cfg, observation_space, action_space = load_gateway_model(ckpt, device="cpu")
    assert model.algo == exp and model.init_state_rows(3) is None
    rng = np.random.RandomState(0)
    obs = {k: (rng.randint(0, 256, (3,) + space.shape).astype(np.uint8) if space.dtype == np.uint8
               else rng.randn(3, *space.shape).astype(np.float32)) for k, space in observation_space.items()}
    actions, _ = model.act(obs, None, torch.Generator())

    from sheeprl_tpu.config import compose as jax_compose

    jax_cfg = jax_compose(overrides=(PIXELS if exp == "sac_ae" else PENDULUM) + [f"exp={exp}"])
    gym_obs = gym.spaces.Dict({k: gym.spaces.Box(s.low, s.high, s.shape, s.dtype)
                               for k, s in observation_space.items()})
    gym_act = gym.spaces.Box(action_space.low, action_space.high, action_space.shape, action_space.dtype)
    jax_policy = jax_find_eval_builder(exp)(None, jax_cfg, jax_read_checkpoint(ckpt), gym_obs, gym_act)
    want, _ = jax_policy.act(obs, None, jax.random.PRNGKey(0))
    np.testing.assert_allclose(actions, np.asarray(want), rtol=0, atol=1e-5)
    _evaluate(ckpt)


@pytest.mark.parametrize("exp,base", [("sac", PENDULUM), ("droq", PENDULUM), ("sac_ae", PIXELS),
                                      ("sac", PENDULUM + ["env.backend=jax"])])
def test_without_a_card_each_entrypoint_raises(tmp_path, monkeypatch, exp, base):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.run(base + [f"exp={exp}", "dry_run=True", f"root_dir={tmp_path}/logs", "run_name=x"])


@pytest.mark.parametrize(
    "exp,extra,error,match",
    [
        ("sac", ["buffer.device_ring=True"], NotImplementedError, "Python plane"),
        ("droq", ["env.act_burst=4"], NotImplementedError, "act_burst"),
        ("droq", ["env.backend=jax"], NotImplementedError, "SAC's training loop only"),
        ("sac", ["env.backend=jax", "env.id=brax/ant"], NotImplementedError, "brax"),
        # the learn probes run now (6h-c); a value no run can honour still raises
        ("sac", ["metric.telemetry.enabled=True", "metric.telemetry.learn.every_n_bursts=0"], ValueError,
         "every_n_bursts must be >= 1"),
    ],
)
def test_the_options_not_ported_raise(tmp_path, monkeypatch, exp, extra, error, match):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(error, match=match):
        _run(tmp_path, exp, PENDULUM, ["dry_run=True"] + extra, "x")

"""The port's DeepMind Control Suite wrapper and the walker preset on the CPU.

- ``sheeprl_tpu_torch.envs.dmc.DMCWrapper`` against the JAX package's on
  ``walker_walk`` (dm_control installed): the spaces, the actions rescaled
  from [-1, 1] to the task's bounds, and the same seed and actions giving
  the same vector observations, rewards, discounts and physics states over
  50 steps (exactly: both step the same simulator with the same float32
  actions). Pixels are compared only where an offscreen renderer loads.
- ``make_env``'s DMC branch against the JAX ``make_env``: keys, action
  repeat and time limit.
- The port's CLI with ``exp=dreamer_v3_dmc_walker_walk_proprio`` on real
  dm_control at tiny widths: it trains on float actions, checkpoints, and
  ``load_gateway_model`` serves float action vectors.
- Sampling an unbounded Box draws gymnasium's standard normals; a
  continuous dummy-env run loads no dm_control.
"""

import os
import subprocess
import sys
from pathlib import Path

import gymnasium as gym
import numpy as np
import pytest

from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.envs.dmc import DMCWrapper as JaxDMCWrapper
from sheeprl_tpu.utils.env import make_env as jax_make_env
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.dmc import DMCWrapper
from sheeprl_tpu_torch.serve.model import load_gateway_model
from sheeprl_tpu_torch.utils.env import make_env

REPO = Path(__file__).resolve().parents[1]
STEPS = 50
TINY = [
    "algo.dense_units=8", "algo.mlp_layers=1", "algo.world_model.recurrent_model.recurrent_state_size=8",
    "algo.world_model.transition_model.hidden_size=8", "algo.world_model.representation_model.hidden_size=8",
    "algo.world_model.stochastic_size=4", "algo.world_model.discrete_size=4", "per_rank_batch_size=2",
    "per_rank_sequence_length=8", "algo.horizon=3",
]


def _pair(**kwargs):
    return DMCWrapper("walker_walk", seed=7, **kwargs), JaxDMCWrapper("walker_walk", seed=7, **kwargs)


def test_spaces_and_action_rescaling_match_jax():
    mine, theirs = _pair(from_pixels=False, from_vectors=True)
    try:
        assert isinstance(mine.action_space, spaces.Box) and mine.action_space.shape == (6,)
        np.testing.assert_array_equal(mine.action_space.low, theirs.action_space.low)
        np.testing.assert_array_equal(mine.action_space.high, theirs.action_space.high)
        state, j_state = mine.observation_space["state"], theirs.observation_space["state"]
        assert list(mine.observation_space.keys()) == ["state"] and state.shape == j_state.shape == (24,)
        assert state.dtype == j_state.dtype and np.isinf(state.low).all() and np.isinf(state.high).all()
        assert mine.reward_range == theirs.reward_range
        np.testing.assert_array_equal(mine._true_action_space.low, theirs._true_action_space.low)
        np.testing.assert_array_equal(mine._true_action_space.high, theirs._true_action_space.high)
        actions = np.concatenate([np.random.RandomState(0).uniform(-1, 1, (20, 6)), -np.ones((1, 6)), np.ones((1, 6))])
        for a in actions.astype(np.float32):
            np.testing.assert_array_equal(mine._denormalize_action(a), theirs._denormalize_action(a))
        np.testing.assert_array_equal(mine._denormalize_action(-np.ones(6)), mine._true_action_space.low)
        np.testing.assert_array_equal(mine._denormalize_action(np.ones(6)), mine._true_action_space.high)
    finally:
        mine.close()
        theirs.close()


def test_the_same_seed_and_actions_give_jax_trajectory():
    mine, theirs = _pair(from_pixels=False, from_vectors=True)
    try:
        obs, info = mine.reset(seed=7)
        j_obs, _ = theirs.reset(seed=7)
        assert info == {}
        np.testing.assert_array_equal(obs["state"], j_obs["state"])
        actions = np.random.RandomState(1).uniform(-1, 1, (STEPS, 6)).astype(np.float32)
        for a in actions:
            obs, reward, terminated, truncated, info = mine.step(a)
            j_obs, j_reward, j_terminated, j_truncated, j_info = theirs.step(a)
            np.testing.assert_array_equal(obs["state"], j_obs["state"])
            assert (reward, terminated, truncated) == (j_reward, j_terminated, j_truncated)
            assert info["discount"] == j_info["discount"]
            np.testing.assert_array_equal(info["internal_state"], j_info["internal_state"])
            np.testing.assert_array_equal(mine.current_state, obs["state"])
    finally:
        mine.close()
        theirs.close()


def test_pixels_match_jax_where_a_renderer_loads():
    try:
        mine, theirs = _pair(from_pixels=True, from_vectors=True, height=64, width=64)
        frame = theirs.reset(seed=7)[0]["rgb"]
    except Exception as exc:  # no offscreen GL backend that loads here
        pytest.skip(f"no offscreen renderer: {exc}")
    try:
        obs, _ = mine.reset(seed=7)
        assert obs["rgb"].shape == (3, 64, 64) and obs["rgb"].dtype == np.uint8
        np.testing.assert_array_equal(obs["rgb"], frame)
        a = np.full(6, 0.3, np.float32)
        np.testing.assert_array_equal(mine.step(a)[0]["rgb"], theirs.step(a)[0]["rgb"])
    finally:
        mine.close()
        theirs.close()


def test_make_env_builds_the_dmc_branch_as_jax_does():
    overrides = ["exp=dreamer_v3_dmc_walker_walk_proprio", "env.capture_video=False", "env.action_repeat=2",
                 "env.max_episode_steps=5"]
    env = make_env(compose(overrides=overrides), seed=3, rank=0)()
    j_env = jax_make_env(jax_compose(overrides=overrides), seed=3, rank=0)()
    try:
        assert list(env.observation_space.keys()) == ["state"] and env.action_space.shape == (6,)
        obs, _ = env.reset(seed=3)
        j_obs, _ = j_env.reset(seed=3)
        np.testing.assert_array_equal(obs["state"], j_obs["state"])
        for step in range(5):
            a = np.full(6, 0.1 * step, np.float32)
            obs, reward, terminated, truncated, info = env.step(a)
            j_obs, j_reward, j_terminated, j_truncated, _ = j_env.step(a)
            np.testing.assert_array_equal(obs["state"], j_obs["state"])
            assert (reward, terminated, truncated) == (j_reward, j_terminated, j_truncated)
        assert truncated and info["episode"]["l"] == 5
    finally:
        env.close()
        j_env.close()


def test_the_port_cli_trains_the_walker_proprio_preset_on_dm_control(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    result = cli.run([
        "exp=dreamer_v3_dmc_walker_walk_proprio", "env.num_envs=1", "env.sync_env=True", "env.capture_video=False",
        "env.max_episode_steps=20", "fabric.accelerator=cpu", "buffer.memmap=False", "buffer.size=200",
        "total_steps=48", "algo.learning_starts=32", "algo.train_every=8", "algo.per_rank_gradient_steps=1",
        "metric.log_every=16", "checkpoint.every=16", f"root_dir={tmp_path}", "run_name=walker", *TINY,
    ])
    assert (result["random_steps"], result["player_steps"], result["gradient_steps"]) == (32, 16, 3)
    assert result["test_steps"] == 20 and np.isfinite(result["test_reward"])
    model, _cfg, observation_space, action_space = load_gateway_model(result["checkpoint"], device="cpu")
    assert action_space.shape == (6,) and list(observation_space.keys()) == ["state"]
    rng = np.random.RandomState(0)
    state = model.init_state_rows(2)
    for _ in range(3):
        actions, state = model.act({"state": rng.randn(2, 24)}, state, None)
        assert actions.shape == (2, 6) and actions.dtype == np.float32 and np.abs(actions).max() <= 1.0


def test_unbounded_box_samples_as_gymnasium():
    mine = spaces.Box(-np.inf, np.inf, (2,), np.float32, seed=4)
    theirs = gym.spaces.Box(-np.inf, np.inf, (2,), np.float32, seed=4)
    for _ in range(5):
        np.testing.assert_array_equal(mine.sample(), theirs.sample())
    half = spaces.Box(np.array([0.0, -np.inf], np.float32), np.array([np.inf, 1.0], np.float32), seed=5)
    j_half = gym.spaces.Box(np.array([0.0, -np.inf], np.float32), np.array([np.inf, 1.0], np.float32), seed=5)
    np.testing.assert_array_equal(half.sample(), j_half.sample())


def test_a_continuous_dummy_run_loads_no_dm_control(tmp_path):
    code = (
        "import sys\n"
        "from sheeprl_tpu_torch import cli\n"
        f"result = cli.run({TINY!r} + ['exp=dreamer_v3', 'env=dummy', 'env.id=continuous_dummy',"
        f" 'env.sync_env=True', 'dry_run=True', 'metric.log_level=0', 'buffer.memmap=False',"
        f" 'per_rank_sequence_length=1', 'algo.learning_starts=0', 'fabric.accelerator=cpu',"
        f" 'algo.world_model.encoder.cnn_channels_multiplier=2', 'root_dir={tmp_path}', 'run_name=c'])\n"
        "assert result['gradient_steps'] == 1\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('dm_control', 'mujoco', 'dm_env', 'gymnasium'))\n"
        "print('loaded:', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert "loaded: []" in proc.stdout

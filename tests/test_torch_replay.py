"""The port's replay buffers, staging, spaces and vector env against the JAX
package's (and gymnasium's, which the JAX package's env loop runs on).

- the same adds and seed give bit-identical samples from the sequential,
  env-independent and transition buffers of both packages, memory-mapped or
  not, before and after the ring wraps;
- ``state_dict`` round trips restore the sampling state, and a state
  written by one package loads into the other's buffer;
- synchronous host staging (``buffer.prefetch=False``) draws the JAX
  stream; the prefetching staging hands out the same batches in order;
- the sync vector env over the dummy envs gives gymnasium's observations,
  rewards, terminations, ``final_obs``/``final_info`` and action samples.
"""

import numpy as np
import pytest
import torch

from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.data import buffers as jax_buffers
from sheeprl_tpu.envs.vector.factory import make_vector_env as jax_make_vector_env
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.data import buffers
from sheeprl_tpu_torch.data.staging import HostStaging
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.vector import make_vector_env

N_ENVS = 3


def _rows(rng, t, n=N_ENVS):
    return {
        "rgb": rng.integers(0, 256, (t, n, 3, 4, 4), dtype=np.uint8),
        "actions": rng.normal(size=(t, n, 2)).astype(np.float32),
        "dones": (rng.random((t, n, 1)) < 0.2).astype(np.float32),
    }


def _pair(kind, size, tmp_path, memmap):
    """The same buffer in both packages."""
    kwargs = dict(obs_keys=("rgb",))
    out = []
    for pkg, name in ((jax_buffers, "jax"), (buffers, "port")):
        mm = dict(memmap=True, memmap_dir=str(tmp_path / name)) if memmap else {}
        if kind == "env_independent":
            b = pkg.EnvIndependentReplayBuffer(size, N_ENVS, buffer_cls=pkg.SequentialReplayBuffer, **kwargs, **mm)
        elif kind == "sequential":
            b = pkg.SequentialReplayBuffer(size, N_ENVS, **kwargs, **mm)
        else:
            b = pkg.ReplayBuffer(size, N_ENVS, **kwargs, **mm)
        b.seed(11)
        out.append(b)
    return out


def _sample(buf, kind):
    if kind == "transition":
        return buf.sample(4, sample_next_obs=True, n_samples=2)
    return buf.sample(4, n_samples=2, sequence_length=5)


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


@pytest.mark.parametrize("memmap", [False, True], ids=["ram", "memmap"])
@pytest.mark.parametrize("kind", ["env_independent", "sequential", "transition"])
def test_same_adds_and_seed_give_identical_samples(kind, memmap, tmp_path):
    jax_buf, buf = _pair(kind, 16, tmp_path, memmap)
    rng = np.random.default_rng(0)
    for step in range(30):  # the ring wraps after 16 rows
        rows = _rows(rng, 1 if step % 5 else 3)
        for b in (jax_buf, buf):
            b.add({k: v.copy() for k, v in rows.items()})
        if kind == "env_independent" and step % 4 == 3:
            extra = _rows(rng, 1, 2)
            for b in (jax_buf, buf):
                b.add({k: v.copy() for k, v in extra.items()}, [2, 0])
        if step >= 6:
            _assert_same(_sample(jax_buf, kind), _sample(buf, kind))


@pytest.mark.parametrize("kind", ["env_independent", "sequential", "transition"])
def test_state_dict_round_trips_across_packages(kind, tmp_path):
    jax_buf, buf = _pair(kind, 12, tmp_path, False)
    rng = np.random.default_rng(1)
    for _ in range(17):
        rows = _rows(rng, 1)
        for b in (jax_buf, buf):
            b.add({k: v.copy() for k, v in rows.items()})
    state, jax_state = buf.state_dict(), jax_buf.state_dict()
    subs = state["buffers"] if kind == "env_independent" else [state]
    jax_subs = jax_state["buffers"] if kind == "env_independent" else [jax_state]
    for sub, jax_sub in zip(subs, jax_subs, strict=True):
        _assert_same(jax_sub["buffer"], sub["buffer"])
        assert (sub["pos"], sub["full"]) == (jax_sub["pos"], jax_sub["full"])
    # the port's state into a fresh JAX buffer and the JAX state into a fresh port buffer
    fresh_jax, fresh = _pair(kind, 12, tmp_path, False)
    fresh_jax.load_state_dict(state)
    fresh.load_state_dict(jax_buf.state_dict())
    for b in (fresh_jax, fresh, jax_buf, buf):
        b.seed(5)
    want = _sample(jax_buf, kind)
    for b in (fresh_jax, fresh, buf):
        _assert_same(want, _sample(b, kind))


@pytest.mark.parametrize("prefetch", [False, True], ids=["sync", "prefetch"])
def test_host_staging_draws_the_jax_stream(prefetch):
    jax_buf, buf = _pair("env_independent", 32, None, False)
    rng = np.random.default_rng(2)
    for _ in range(20):
        rows = _rows(rng, 1)
        for b in (jax_buf, buf):
            b.add({k: v.copy() for k, v in rows.items()})
    staging = HostStaging(buf, torch.device("cpu"), sequence_mode=True, prefetch=prefetch)
    try:
        for _ in range(4):  # no adds in between: the prefetched bursts are the next draws
            got = staging.sample_device(4, sequence_length=5, n_samples=2)
            want = jax_buf.sample(4, n_samples=2, sequence_length=5)
            assert all(isinstance(v, torch.Tensor) for v in got.values())
            _assert_same(want, {k: v.numpy() for k, v in got.items()})
    finally:
        staging.close()
    assert staging.prefetch_hits == (2 if prefetch else 0)


@pytest.mark.parametrize("env_id", ["discrete_dummy", "multidiscrete_dummy", "continuous_dummy"])
def test_sync_vector_env_matches_gymnasium(env_id):
    overrides = ["exp=dreamer_v2", "env=dummy", f"env.id={env_id}", f"env.num_envs={N_ENVS}", "env.sync_env=True"]
    jax_envs = jax_make_vector_env(jax_compose(overrides=overrides), None, None, restart_on_exception=True)
    envs = make_vector_env(compose(overrides=overrides), None, None, restart_on_exception=True)
    assert envs.single_observation_space["rgb"].shape == jax_envs.single_observation_space["rgb"].shape
    _assert_same(jax_envs.reset(seed=5)[0], envs.reset(seed=5)[0])
    ended = 0
    for _ in range(12):
        jax_action = jax_envs.action_space.sample()
        action = envs.action_space.sample()
        if env_id != "multidiscrete_dummy":  # gymnasium batches MultiDiscrete into an int Box
            np.testing.assert_array_equal(jax_action, action)
        jax_out, out = jax_envs.step(jax_action), envs.step(jax_action)
        _assert_same(jax_out[0], out[0])
        for a, b in zip(jax_out[1:4], out[1:4]):
            np.testing.assert_array_equal(a, b)
        jax_info, info = jax_out[4], out[4]
        assert jax_info.keys() == info.keys()
        if "final_obs" in info:
            ended += 1
            np.testing.assert_array_equal(jax_info["_final_obs"], info["_final_obs"])
            for a, b in zip(jax_info["final_obs"], info["final_obs"]):
                assert (a is None) == (b is None)
                if b is not None:
                    _assert_same(a, b)
            assert jax_info["final_info"].keys() == info["final_info"].keys()
            np.testing.assert_array_equal(jax_info["final_info"]["episode"]["l"], info["final_info"]["episode"]["l"])
            np.testing.assert_array_equal(jax_info["final_info"]["episode"]["r"], info["final_info"]["episode"]["r"])
    assert ended == (2 if env_id == "discrete_dummy" else 0)
    jax_envs.close()
    envs.close()


def test_spaces_sample_like_gymnasium():
    import gymnasium as gym

    pairs = [
        (gym.spaces.Discrete(5, seed=3), spaces.Discrete(5, seed=3)),
        (gym.spaces.MultiDiscrete([2, 7, 3], seed=4), spaces.MultiDiscrete([2, 7, 3], seed=4)),
        (gym.spaces.Box(-1.0, 2.0, (3, 2), np.float32, seed=5), spaces.Box(-1.0, 2.0, (3, 2), np.float32, seed=5)),
        (gym.spaces.Box(-np.inf, np.inf, (4,), np.float32, seed=6), spaces.Box(-np.inf, np.inf, (4,), np.float32, seed=6)),
    ]
    for theirs, ours in pairs:
        for _ in range(5):
            np.testing.assert_array_equal(np.asarray(theirs.sample()), np.asarray(ours.sample()))
        assert spaces.from_gymnasium(theirs).shape == ours.shape

"""The port's shared-memory worker pool (``env.vectorization=async``,
``sheeprl_tpu_torch/envs/vector``) against its sync vector env and the JAX
package's ``AsyncSharedMemVectorEnv``, on the CPU.

- seeded **bitwise** parity on the dummy envs: observations, rewards,
  flags, the ``SAME_STEP`` autoreset's ``final_obs`` and the ``_``-masked
  info keys, against the sync env and against JAX's pool on the same env and
  seeds (the dummy envs are the same on both sides);
- the slabs' contract: ``step`` returns views of the shared blocks, the
  previous step's views survive the next step, the buffer's ``add`` is the
  one copy;
- faults (as ``tests/test_envs/test_vector.py``): a crashed worker restarts
  and the pool serves on; the restart budget is forgiven outside its window;
  a hung worker degrades the pool to sync; ``gym_async`` raises on a worker
  error; a crashed run with the pool open exits; a SIGTERM drains the pool
  and leaves a resumable run.

The fault envs are this module's classes: a worker unpickles its thunk (a
``partial`` of a class) by importing this module, so its top level imports
no JAX.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
from functools import partial

import numpy as np
import pytest

from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.vector import (
    AsyncSharedMemVectorEnv,
    SyncVectorEnv,
    env_seeds,
    make_vector_env,
    vectorize_thunks,
)
from sheeprl_tpu_torch.envs.wrappers import Env


def _cfg(num_envs=2, vectorization="sync", **env_over):
    cfg = compose(overrides=["exp=ppo", "env=dummy", "env.id=discrete_dummy", "env.capture_video=False",
                             "metric.log_level=0", f"env.num_envs={num_envs}", "cnn_keys.encoder=[rgb]",
                             "mlp_keys.encoder=[]"])
    cfg.env.sync_env = None
    cfg.env.vectorization = vectorization
    for k, v in env_over.items():
        cfg.env[k] = v
    return cfg


def _same_step(a, b, t):
    for k in a[0]:
        assert np.array_equal(a[0][k], b[0][k]), (t, k)
        assert a[0][k].dtype == b[0][k].dtype, (t, k)
    for j in (1, 2, 3):
        assert np.array_equal(a[j], b[j]) and a[j].dtype == b[j].dtype, (t, j)
    assert sorted(a[4]) == sorted(b[4]), t
    if "final_obs" in a[4]:
        assert np.array_equal(a[4]["_final_obs"], b[4]["_final_obs"])
        for idx in np.nonzero(a[4]["_final_obs"])[0]:
            for k in a[4]["final_obs"][idx]:
                assert np.array_equal(a[4]["final_obs"][idx][k], b[4]["final_obs"][idx][k]), (t, idx, k)
        return True
    return False


def test_the_pool_is_bitwise_the_sync_env_and_jax_s_pool():
    from sheeprl_tpu.config.engine import compose as jax_compose
    from sheeprl_tpu.envs.vector import make_vector_env as jax_make_vector_env

    jcfg = jax_compose("config", overrides=["exp=ppo", "env=dummy", "env.id=discrete_dummy", "env.capture_video=False",
                                            "metric.log_level=0", "env.num_envs=3", "cnn_keys.encoder=[rgb]",
                                            "mlp_keys.encoder=[]"])
    jcfg.env.sync_env, jcfg.env.vectorization = None, "async"
    pools = [make_vector_env(_cfg(3)), make_vector_env(_cfg(3, "async")), jax_make_vector_env(jcfg, None, None)]
    try:
        assert isinstance(pools[1], AsyncSharedMemVectorEnv) and isinstance(pools[0], SyncVectorEnv)
        first = [p.reset(seed=5)[0] for p in pools]
        for o in first[1:]:
            assert all(np.array_equal(first[0][k], o[k]) for k in o)
        rng = np.random.default_rng(0)
        autoreset = False
        for t in range(8):  # the discrete dummy's episode is 5 steps: 8 cross an autoreset
            acts = rng.integers(0, 2, size=3)
            steps = [p.step(acts) for p in pools]
            autoreset |= _same_step(steps[0], steps[1], t)
            _same_step(steps[1], steps[2], t)
        assert autoreset
    finally:
        for p in pools:
            p.close()


def test_step_returns_views_of_the_slabs_and_the_buffer_add_copies():
    from sheeprl_tpu_torch.data.buffers import ReplayBuffer

    envs = make_vector_env(_cfg(2, "async"))
    try:
        obs, _ = envs.reset(seed=1)
        slab_obs = envs._slabs.views()[0]
        for k, arr in obs.items():
            assert arr.shape[0] == 2 and np.shares_memory(arr, slab_obs[k]), k
        acts = np.zeros(2, dtype=np.int64)
        obs1 = envs.step(acts)[0]
        snapshot = {k: v.copy() for k, v in obs1.items()}
        obs2 = envs.step(acts)[0]
        for k in obs1:
            assert np.array_equal(obs1[k], snapshot[k]) and not np.shares_memory(obs1[k], obs2[k]), k
        rb = ReplayBuffer(8, 2, obs_keys=("rgb",))
        rb.add({"rgb": obs2["rgb"][None]})
        assert np.array_equal(rb["rgb"][0], obs2["rgb"]) and not np.shares_memory(rb["rgb"], obs2["rgb"])
    finally:
        envs.close()
    with pytest.raises(ValueError, match="never fork"):
        AsyncSharedMemVectorEnv([], context="fork")


# -- faults ------------------------------------------------------------------------


class CrashOnceEnv(Env):
    """Env ``crash_index`` raises at step ``crash_at_step`` while ``sentinel``
    exists (removed as it raises, so that the rebuilt env does not crash again)."""

    def __init__(self, index, crash_index, crash_at_step, sentinel):
        self.observation_space = spaces.Dict({"state": spaces.Box(-np.inf, np.inf, (3,), np.float32)})
        self.action_space = spaces.Discrete(2)
        self._index, self._crash = index, (crash_index, crash_at_step, sentinel)
        self._step = 0

    def _obs(self):
        return {"state": np.full(3, self._step, dtype=np.float32)}

    def reset(self, *, seed=None, options=None):
        self._step = 0
        return self._obs(), {}

    def step(self, action):
        self._step += 1
        crash_index, crash_at_step, sentinel = self._crash
        if self._index == crash_index and self._step == crash_at_step and os.path.exists(sentinel):
            os.unlink(sentinel)
            raise RuntimeError("simulated env crash")
        return self._obs(), 1.0, self._step >= 6, False, {}


class HangingEnv(Env):
    """Env ``hang_index`` blocks in ``step`` while ``sentinel`` exists."""

    def __init__(self, index, hang_index, sentinel):
        self.observation_space = spaces.Dict({"state": spaces.Box(-np.inf, np.inf, (2,), np.float32)})
        self.action_space = spaces.Discrete(2)
        self._index, self._hang, self._sentinel = index, hang_index, sentinel
        self._step = 0

    def reset(self, *, seed=None, options=None):
        self._step = 0
        return {"state": np.zeros(2, np.float32)}, {}

    def step(self, action):
        self._step += 1
        if self._index == self._hang:
            while os.path.exists(self._sentinel):
                time.sleep(0.05)
        return {"state": np.full(2, self._step, np.float32)}, 1.0, False, False, {}


def _crashing(n, crash_index, crash_at_step, sentinel):
    return [partial(CrashOnceEnv, i, crash_index, crash_at_step, sentinel) for i in range(n)]


def test_a_crashed_worker_restarts_and_the_pool_serves_on(tmp_path):
    sentinel = str(tmp_path / "crash_armed")
    open(sentinel, "w").close()
    cfg = _cfg(2, "async")
    envs = vectorize_thunks(_crashing(2, 1, 2, sentinel), cfg, env_seeds_list=env_seeds(cfg.seed, 0, 2))
    try:
        envs.reset(seed=cfg.seed)
        acts = np.zeros(2, dtype=np.int64)
        envs.step(acts)
        with pytest.warns(UserWarning, match="an auto-reset replaces the lost step"):
            obs, rew, term, trunc, infos = envs.step(acts)  # env 1 dies
        assert envs.worker_restarts == 1 and not envs.degraded_to_sync
        assert rew[1] == 0.0 and not term[1] and not trunc[1]
        assert infos["env_worker_restart"][1] and not infos["env_worker_restart"][0]
        assert np.array_equal(obs["state"][1], np.zeros(3, np.float32))
        assert rew[0] == 1.0 and np.array_equal(obs["state"][0], np.full(3, 2, np.float32))
        for _ in range(4):
            obs, rew, *_ = envs.step(acts)
        assert rew[0] == 1.0 and rew[1] == 1.0
    finally:
        envs.close()


def test_the_restart_budget_is_forgiven_outside_its_window(tmp_path):
    sentinel = str(tmp_path / "crash_armed")
    open(sentinel, "w").close()
    cfg = _cfg(2, "async", max_worker_restarts=1, restart_window_s=5.0)
    envs = vectorize_thunks(_crashing(2, 1, 1, sentinel), cfg, env_seeds_list=env_seeds(cfg.seed, 0, 2))
    try:
        envs.reset(seed=cfg.seed)
        acts = np.zeros(2, dtype=np.int64)
        with pytest.warns(UserWarning):
            envs.step(acts)  # crash 1: restart 1/1 in the window
        assert envs.worker_restarts == 1 and not envs.degraded_to_sync
        envs._restart_times[0] -= 10.0  # age it out of the window
        open(sentinel, "w").close()
        with pytest.warns(UserWarning):
            envs.step(acts)  # the rebuilt env is at step 1 again: crash 2
        assert envs.worker_restarts == 2 and len(envs._restart_times) == 1 and not envs.degraded_to_sync
        envs.step(acts)
    finally:
        if os.path.exists(sentinel):
            os.unlink(sentinel)
        envs.close()


def test_a_hung_worker_times_out_and_the_pool_degrades_to_sync(tmp_path):
    sentinel = str(tmp_path / "hang")
    open(sentinel, "w").close()
    cfg = _cfg(2, "async", worker_timeout_s=1.5, max_worker_restarts=0)
    envs = vectorize_thunks([partial(HangingEnv, i, 0, sentinel) for i in range(2)], cfg,
                            env_seeds_list=env_seeds(cfg.seed, 0, 2))
    try:
        envs.reset(seed=cfg.seed)
        acts = np.zeros(2, dtype=np.int64)
        with pytest.warns(UserWarning, match="degrading to in-process sync"):
            obs, rew, term, trunc, infos = envs.step(acts)
        assert envs.degraded_to_sync
        assert np.all(rew == 0.0) and not term.any() and not trunc.any() and infos["env_worker_restart"].all()
        os.unlink(sentinel)
        obs, rew, *_ = envs.step(acts)
        assert np.all(rew == 1.0) and np.array_equal(obs["state"], np.full((2, 2), 1, np.float32))
    finally:
        if os.path.exists(sentinel):
            os.unlink(sentinel)
        envs.close()


def test_gym_async_raises_on_a_worker_error(tmp_path):
    sentinel = str(tmp_path / "crash_armed")
    open(sentinel, "w").close()
    cfg = _cfg(2, "gym_async")
    envs = vectorize_thunks(_crashing(2, 0, 1, sentinel), cfg, env_seeds_list=env_seeds(cfg.seed, 0, 2))
    try:
        assert isinstance(envs, AsyncSharedMemVectorEnv) and not envs.restart_workers
        envs.reset(seed=cfg.seed)
        with pytest.raises(RuntimeError, match="simulated env crash"):
            envs.step(np.zeros(2, dtype=np.int64))
    finally:
        envs.close()


def test_a_crashed_run_with_the_pool_open_exits(tmp_path):
    """The workers ignore SIGTERM: without the pool's exit hook,
    multiprocessing's own would join them forever."""
    script = tmp_path / "crash_run.py"
    script.write_text(
        "from sheeprl_tpu_torch.config import compose\n"
        "from sheeprl_tpu_torch.envs.vector import make_vector_env\n\n"
        "if __name__ == '__main__':\n"
        "    cfg = compose(overrides=['exp=ppo', 'env=dummy', 'env.id=discrete_dummy', 'cnn_keys.encoder=[rgb]',\n"
        "                             'mlp_keys.encoder=[]', 'env.vectorization=async', 'env.num_envs=2'])\n"
        "    envs = make_vector_env(cfg)\n"
        "    envs.reset(seed=0)\n"
        "    raise RuntimeError('simulated training crash with the pool still open')\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, str(script)], capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": repo})
    assert proc.returncode != 0 and "simulated training crash" in proc.stderr


def test_the_eval_pool_takes_the_async_backend():
    from sheeprl_tpu_torch.evals.service import make_eval_pool

    pool, seeds = make_eval_pool(_cfg(2, "async"), None, 2, 100)
    try:
        assert isinstance(pool, AsyncSharedMemVectorEnv) and seeds == [100, 101]
        sync, _ = make_eval_pool(_cfg(2), None, 2, 100)
        a, b = pool.reset(seed=seeds)[0], sync.reset(seed=seeds)[0]
        assert np.array_equal(a["rgb"], b["rgb"])
        sync.close()
    finally:
        pool.close()


def test_sigterm_drains_the_pool_and_leaves_a_resumable_run(tmp_path, monkeypatch):
    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.ckpt import read_checkpoint, resolve_latest
    from sheeprl_tpu_torch.ckpt.preemption import reset_preemption

    monkeypatch.chdir(tmp_path)
    timer = threading.Timer(4.0, os.kill, (os.getpid(), signal.SIGTERM))
    timer.start()
    try:
        cli.run(["exp=ppo", "env=dummy", "env.id=discrete_dummy", "env.vectorization=async", "env.num_envs=2",
                 "env.capture_video=False", "metric.log_level=0", "buffer.memmap=False", "fabric.accelerator=cpu",
                 "algo.rollout_steps=4", "per_rank_batch_size=4", "algo.update_epochs=1", "cnn_keys.encoder=[rgb]",
                 "mlp_keys.encoder=[]", "algo.encoder.cnn_features_dim=16", "algo.run_test=False",
                 "total_steps=40000", "checkpoint.every=1000000", "checkpoint.save_last=True",
                 f"root_dir={tmp_path}/logs", "run_name=test"])
    finally:
        timer.cancel()
        reset_preemption()
    latest = resolve_latest(f"{tmp_path}/logs")
    assert latest is not None, "the preemption left no resumable checkpoint"
    assert 0 < int(np.asarray(read_checkpoint(latest, with_rb=False)["update"])) < 40000 // 8

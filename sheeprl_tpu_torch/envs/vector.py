"""The vector env every entrypoint builds its envs through (counterpart of
``sheeprl_tpu/envs/vector/factory.py``), with the ``sync`` backend only.

:class:`SyncVectorEnv` steps its envs one after the other with gymnasium's
``SAME_STEP`` autoreset: an env that terminates or truncates is reset in the
same ``step`` call, the returned observation is the reset one, and the
episode's last observation and info come back in ``infos["final_obs"]`` (an
object array holding a dict for each env that ended, None elsewhere) and
``infos["final_info"]``, each key beside a ``_<key>`` mask, in gymnasium's
layout.

``env.vectorization=async`` / ``gym_async`` (the shared-memory worker pool)
is not ported: it raises. ``env.backend=jax`` selects the device envs and
the rollout engine (:mod:`sheeprl_tpu_torch.envs.rollout`) instead of this
plane; SAC branches on :func:`resolve_backend` before it builds envs, and
any other entrypoint that asks this factory for a ``jax`` backend gets an
error, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from sheeprl_tpu_torch.envs.spaces import batch_space
from sheeprl_tpu_torch.envs.wrappers import Env, RestartOnException
from sheeprl_tpu_torch.utils.env import make_env

__all__ = [
    "SyncVectorEnv",
    "env_seeds",
    "make_eval_env",
    "make_vector_env",
    "resolve_backend",
    "resolve_vectorization",
]

_BACKENDS = ("sync", "async", "gym_async")
_ENV_BACKENDS = ("python", "jax")


def resolve_backend(cfg) -> str:
    """``env.backend``: ``python`` (this vector-env plane, the default) or
    ``jax`` (the device envs and the rollout engine, whose whole collection
    burst is one CUDA graph replay). The name stays the JAX package's: the
    config tree is shared."""
    backend = str(cfg.env.get("backend", "python") or "python").lower()
    if backend not in _ENV_BACKENDS:
        raise ValueError(f"env.backend must be one of {_ENV_BACKENDS}, got {backend!r}")
    return backend


def env_seeds(seed: int, rank: int, n_envs: int) -> List[int]:
    """Canonical per-env seeds: ``seed + rank * n_envs + idx``."""
    return [int(seed) + int(rank) * int(n_envs) + idx for idx in range(int(n_envs))]


def resolve_vectorization(cfg) -> str:
    """An explicitly set ``env.vectorization`` wins; else the legacy
    ``env.sync_env`` (True → sync, False → gym_async); else sync."""
    mode = cfg.env.get("vectorization", None)
    if mode is not None:
        mode = str(mode).lower()
        if mode not in _BACKENDS:
            raise ValueError(f"env.vectorization must be one of {_BACKENDS}, got {mode!r}")
        return mode
    legacy = cfg.env.get("sync_env", None)
    if legacy is not None:
        return "sync" if legacy else "gym_async"
    return "sync"


def _add_info(infos: Dict[str, Any], info: Dict[str, Any], i: int, n: int) -> Dict[str, Any]:
    """Merge env ``i``'s info into the vector infos: each key an array over
    the envs beside its ``_key`` mask, nested dicts merged recursively."""
    for k, v in info.items():
        if isinstance(v, dict):
            infos[k] = _add_info(infos.get(k, {}), v, i, n)
            mask = infos.setdefault(f"_{k}", np.zeros(n, bool))
            mask[i] = True
            continue
        if k not in infos:
            if isinstance(v, (bool, np.bool_)):
                infos[k] = np.zeros(n, bool)
            elif isinstance(v, (int, np.integer)):
                infos[k] = np.zeros(n, np.int64)
            elif isinstance(v, (float, np.floating)):
                infos[k] = np.zeros(n, np.float64)
            else:
                infos[k] = np.full(n, None, dtype=object)
            infos[f"_{k}"] = np.zeros(n, bool)
        infos[k][i] = v
        infos[f"_{k}"][i] = True
    return infos


class SyncVectorEnv:
    """``n`` envs stepped serially with same-step autoreset."""

    def __init__(self, env_fns: Sequence[Callable[[], Env]]):
        self.envs = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        self.single_observation_space = self.envs[0].observation_space
        self.single_action_space = self.envs[0].action_space
        self.observation_space = batch_space(self.single_observation_space, self.num_envs)
        self.action_space = batch_space(self.single_action_space, self.num_envs)

    def _stack(self, obs: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        return {k: np.stack([np.asarray(o[k]) for o in obs]) for k in obs[0]}

    def reset(self, *, seed=None, options: Optional[Dict[str, Any]] = None):
        """``seed``: None, an int (env ``i`` gets ``seed + i``) or one seed an env."""
        if seed is None:
            seeds = [None] * self.num_envs
        elif isinstance(seed, (list, tuple)):
            if len(seed) != self.num_envs:
                raise ValueError(f"{len(seed)} seeds for {self.num_envs} envs")
            seeds = [None if s is None else int(s) for s in seed]
        else:
            seeds = [int(seed) + i for i in range(self.num_envs)]
        obs, infos = [], {}
        for i, (env, s) in enumerate(zip(self.envs, seeds)):
            o, info = env.reset(seed=s, options=options)
            obs.append(o)
            infos = _add_info(infos, info, i, self.num_envs)
        return self._stack(obs), infos

    def step(self, actions):
        actions = np.asarray(actions)
        obs, infos = [], {}
        rewards = np.zeros(self.num_envs, np.float64)
        terminated = np.zeros(self.num_envs, bool)
        truncated = np.zeros(self.num_envs, bool)
        for i, env in enumerate(self.envs):
            o, rewards[i], terminated[i], truncated[i], info = env.step(actions[i])
            if terminated[i] or truncated[i]:
                infos = _add_info(infos, {"final_obs": None, "final_info": info}, i, self.num_envs)
                infos["final_obs"][i] = o
                o, info = env.reset()
            obs.append(o)
            infos = _add_info(infos, info, i, self.num_envs)
        return self._stack(obs), rewards, terminated, truncated, infos

    def close(self) -> None:
        for env in self.envs:
            env.close()


def _check_plane(cfg) -> None:
    if resolve_backend(cfg) == "jax":
        raise NotImplementedError(
            "env.backend=jax: the device envs and the rollout engine (item 6d) drive SAC's training loop only, "
            "as in the JAX package; run this algorithm with env.backend=python"
        )
    mode = resolve_vectorization(cfg)
    if mode != "sync":
        raise NotImplementedError(
            f"env.vectorization={mode}: the port has the sync vector env only; the worker-pool backends "
            "are ROADMAP queue A item 6e (pass env.sync_env=True or env.vectorization=sync)"
        )


def make_vector_env(
    cfg,
    fabric=None,
    log_dir: Optional[str] = None,
    prefix: str = "train",
    restart_on_exception: bool = False,
    n_envs: Optional[int] = None,
) -> SyncVectorEnv:
    """The train-time vector env: ``env.num_envs`` envs (times the world
    size), seeded ``seed + idx``, each optionally behind
    :class:`RestartOnException`."""
    _check_plane(cfg)
    rank = int(fabric.global_rank) if fabric is not None else 0
    if n_envs is None:
        n_envs = int(cfg.env.num_envs) * (int(fabric.world_size) if fabric is not None else 1)
    seeds = env_seeds(cfg.seed, rank, n_envs)
    thunks = []
    for idx in range(n_envs):
        thunk = make_env(cfg, seeds[idx], 0, log_dir if rank == 0 else None, prefix, vector_env_idx=rank * n_envs + idx)
        if restart_on_exception:
            thunk = (lambda t: lambda: RestartOnException(t))(thunk)
        thunks.append(thunk)
    return SyncVectorEnv(thunks)


def make_eval_env(cfg, log_dir: Optional[str], prefix: str = "test", rank: int = 0) -> Env:
    """One fully wrapped env for test episodes: the same wrappers and the
    same seed (env 0 of ``rank``) as the train-time factory."""
    seed = env_seeds(cfg.seed, rank, 1)[0]
    return make_env(cfg, seed, 0, log_dir, prefix, vector_env_idx=0)()

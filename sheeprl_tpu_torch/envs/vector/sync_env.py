"""The serial vector env (``env.vectorization=sync``; gymnasium's
``SyncVectorEnv`` with ``SAME_STEP`` autoreset in the JAX package).

An env that terminates or truncates is reset in the same ``step`` call, the
returned observation is the reset one, and the episode's last observation
and info come back in ``infos["final_obs"]`` (an object array holding a
dict for each env that ended, None elsewhere) and ``infos["final_info"]``,
each key beside a ``_<key>`` mask, in gymnasium's layout (:func:`add_info`,
which the worker pool shares).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from sheeprl_tpu_torch.envs.spaces import batch_space
from sheeprl_tpu_torch.envs.wrappers import Env

__all__ = ["SyncVectorEnv", "add_final", "add_info", "expand_seeds"]


def add_info(infos: Dict[str, Any], info: Dict[str, Any], i: int, n: int) -> Dict[str, Any]:
    """Merge env ``i``'s info into the vector infos: each key an array over
    the envs beside its ``_key`` mask, nested dicts merged recursively."""
    for k, v in info.items():
        if isinstance(v, dict):
            infos[k] = add_info(infos.get(k, {}), v, i, n)
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


def expand_seeds(seed: Any, n: int) -> List[Optional[int]]:
    """``reset(seed=...)``'s seeds: None, an int (env ``i`` gets ``seed + i``)
    or one seed an env."""
    if seed is None:
        return [None] * n
    if isinstance(seed, (list, tuple)):
        if len(seed) != n:
            raise ValueError(f"{len(seed)} seeds for {n} envs")
        return [None if s is None else int(s) for s in seed]
    return [int(seed) + i for i in range(n)]


def add_final(infos: Dict[str, Any], i: int, n: int, final_obs: Any, final_info: Dict[str, Any]) -> Dict[str, Any]:
    """Env ``i`` ended this step: its last observation under ``final_obs``
    (an object array) and its last info under ``final_info``."""
    infos = add_info(infos, {"final_obs": None, "final_info": final_info}, i, n)
    infos["final_obs"][i] = final_obs
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
        obs, infos = [], {}
        for i, (env, s) in enumerate(zip(self.envs, expand_seeds(seed, self.num_envs))):
            o, info = env.reset(seed=s, options=options)
            obs.append(o)
            infos = add_info(infos, info, i, self.num_envs)
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
                infos = add_final(infos, i, self.num_envs, o, info)
                o, info = env.reset()
            obs.append(o)
            infos = add_info(infos, info, i, self.num_envs)
        return self._stack(obs), rewards, terminated, truncated, infos

    def close(self) -> None:
        for env in self.envs:
            env.close()

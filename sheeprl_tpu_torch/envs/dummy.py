"""Deterministic dummy environments (counterpart of ``sheeprl_tpu/envs/dummy.py``)
on the port's spaces: a fixed-length episode of uint8 CHW image
observations and zero reward, one env per action-space type."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.wrappers import Env

__all__ = ["ContinuousDummyEnv", "DiscreteDummyEnv", "MultiDiscreteDummyEnv"]


class _DummyBase(Env):
    """Zero obs, zero reward, terminated at the step after ``n_steps``."""

    def __init__(self, size: Tuple[int, int, int], n_steps: int):
        self.observation_space = spaces.Box(0, 255, shape=size, dtype=np.uint8)
        self._n_steps = n_steps
        self._step = 0

    def _obs(self) -> np.ndarray:
        return np.zeros(self.observation_space.shape, dtype=np.uint8)

    def step(self, action):
        done = self._step == self._n_steps
        self._step += 1
        return self._obs(), 0.0, done, False, {}

    def reset(self, *, seed: Optional[int] = None, options=None):
        self._step = 0
        return self._obs(), {}


class ContinuousDummyEnv(_DummyBase):
    """Box action space."""

    def __init__(self, action_dim: int = 2, size: Tuple[int, int, int] = (3, 64, 64), n_steps: int = 128):
        super().__init__(size, n_steps)
        self.action_space = spaces.Box(-np.inf, np.inf, shape=(action_dim,))


class DiscreteDummyEnv(_DummyBase):
    """Discrete action space; observations are seeded random uint8 on step."""

    def __init__(self, action_dim: int = 2, size: Tuple[int, int, int] = (3, 64, 64), n_steps: int = 4):
        super().__init__(size, n_steps)
        self.action_space = spaces.Discrete(action_dim)
        self._rng = np.random.default_rng(0)

    def step(self, action):
        done = self._step == self._n_steps
        self._step += 1
        obs = self._rng.integers(0, 256, self.observation_space.shape, dtype=np.uint8)
        return obs, 0.0, done, False, {}


class MultiDiscreteDummyEnv(_DummyBase):
    """MultiDiscrete action space."""

    def __init__(
        self,
        action_dims: Optional[List[int]] = None,
        size: Tuple[int, int, int] = (3, 64, 64),
        n_steps: int = 128,
    ):
        super().__init__(size, n_steps)
        self.action_space = spaces.MultiDiscrete(action_dims or [2, 2])

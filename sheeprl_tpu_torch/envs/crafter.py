"""Crafter wrapper (counterpart of ``sheeprl_tpu/envs/crafter.py``):
``crafter_reward`` / ``crafter_nonreward`` behind the port's five-tuple env
interface, with a single ``rgb`` observation key. Import-gated on
``crafter``."""

from __future__ import annotations

from sheeprl_tpu_torch.utils.imports import _IS_CRAFTER_AVAILABLE

if not _IS_CRAFTER_AVAILABLE:
    raise ModuleNotFoundError("crafter is required: pip install crafter")

from typing import Any, Dict, Optional, Tuple, Union

import crafter
import numpy as np

from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.wrappers import Wrapper


class CrafterWrapper(Wrapper):
    def __init__(self, id: str, screen_size: Union[int, Tuple[int, int]], seed: Optional[int] = None):
        if id not in ("crafter_reward", "crafter_nonreward"):
            raise ValueError(f"Unknown crafter id: {id}")
        if isinstance(screen_size, int):
            screen_size = (screen_size, screen_size)
        self.env = crafter.Env(size=screen_size, seed=seed, reward=(id == "crafter_reward"))
        inner = self.env.observation_space
        self.observation_space = spaces.Dict({"rgb": spaces.Box(inner.low, inner.high, inner.shape, inner.dtype)})
        self.action_space = spaces.Discrete(self.env.action_space.n)
        self.reward_range = self.env.reward_range or (-np.inf, np.inf)
        self.observation_space.seed(seed)
        self.action_space.seed(seed)
        self.render_mode = "rgb_array"
        self.metadata = {"render_fps": 30}

    def step(self, action: Any):
        obs, reward, done, info = self.env.step(action)
        return {"rgb": obs}, reward, done, False, info

    def reset(self, *, seed: Optional[int] = None, options: Optional[Dict[str, Any]] = None):
        return {"rgb": self.env.reset()}, {}

    def render(self):
        return self.env.render()

    def close(self) -> None:
        return

    @property
    def unwrapped(self):
        return self

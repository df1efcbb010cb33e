"""DIAMBRA Arena wrapper (counterpart of ``sheeprl_tpu/envs/diambra.py``):
arcade fighting games with a discrete or multi-discrete action space behind
the port's env interface; every non-Box observation key becomes an integer
Box. DIAMBRA hands out gymnasium spaces, which are read here by their
attributes, so this module imports no gymnasium. Import-gated on ``diambra``
and ``diambra.arena``."""

from __future__ import annotations

import warnings

from sheeprl_tpu_torch.utils.imports import _IS_DIAMBRA_ARENA_AVAILABLE, _IS_DIAMBRA_AVAILABLE

if not _IS_DIAMBRA_AVAILABLE or not _IS_DIAMBRA_ARENA_AVAILABLE:
    raise ModuleNotFoundError("diambra and diambra-arena are required: pip install diambra diambra-arena")

from typing import Any, Dict, Optional, Tuple, Union

import diambra
import diambra.arena
import numpy as np
from diambra.arena import EnvironmentSettings, SpaceTypes, WrappersSettings

from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.wrappers import Wrapper


def _resolve_space_type(name: str):
    # the config carries the reference's dotted string form
    return SpaceTypes.DISCRETE if name.rsplit(".", 1)[-1] == "DISCRETE" else SpaceTypes.MULTI_DISCRETE


def _observation_space(space) -> spaces.Space:
    """The port's Box for one of DIAMBRA's observation spaces: a Box as it is,
    a Discrete(n) as a 1-wide int32 Box of [0, n - 1], a MultiDiscrete as an
    int32 Box of [0, nvec - 1]."""
    kind = type(space).__name__
    if kind == "Box":
        return spaces.Box(space.low, space.high, space.shape, space.dtype)
    if kind == "Discrete":
        return spaces.Box(0, int(space.n) - 1, (1,), np.int32)
    if kind == "MultiDiscrete":
        nvec = np.asarray(space.nvec)
        return spaces.Box(np.zeros_like(nvec), nvec - 1, (len(nvec),), np.int32)
    raise RuntimeError(f"Invalid observation space, got: {type(space)}")


class DiambraWrapper(Wrapper):
    def __init__(
        self,
        id: str,
        action_space: str = "diambra.arena.SpaceTypes.DISCRETE",
        screen_size: Union[int, Tuple[int, int]] = 64,
        grayscale: bool = False,
        repeat_action: int = 1,
        rank: int = 0,
        diambra_settings: Optional[Dict[str, Any]] = None,
        diambra_wrappers: Optional[Dict[str, Any]] = None,
        render_mode: str = "rgb_array",
        log_level: int = 0,
        increase_performance: bool = True,
    ) -> None:
        if isinstance(screen_size, int):
            screen_size = (screen_size, screen_size)
        diambra_settings = dict(diambra_settings or {})
        diambra_wrappers = dict(diambra_wrappers or {})

        for disabled in ("frame_shape", "n_players"):
            if diambra_settings.pop(disabled, None) is not None:
                warnings.warn(f"The DIAMBRA {disabled} setting is disabled")
        role = diambra_settings.pop("role", None)
        self._action_type = "discrete" if _resolve_space_type(action_space) == SpaceTypes.DISCRETE else "multi-discrete"
        settings = EnvironmentSettings(
            **diambra_settings,
            game_id=id,
            action_space=_resolve_space_type(action_space),
            n_players=1,
            role=role,
            render_mode=render_mode,
        )
        if repeat_action > 1:
            if getattr(settings, "step_ratio", 1) > 1:
                warnings.warn(f"step_ratio modified to 1 because the sticky action is active ({repeat_action})")
            settings.step_ratio = 1
        for disabled in ("frame_shape", "stack_frames", "dilation", "flatten"):
            if diambra_wrappers.pop(disabled, None) is not None:
                warnings.warn(f"The DIAMBRA {disabled} wrapper is disabled")
        wrappers = WrappersSettings(**diambra_wrappers, flatten=True, repeat_action=repeat_action)
        # resize in the engine (fast) or in the wrapper
        if increase_performance:
            settings.frame_shape = screen_size + (int(grayscale),)
        else:
            wrappers.frame_shape = screen_size + (int(grayscale),)
        super().__init__(
            diambra.arena.make(id, settings, wrappers, rank=rank, render_mode=render_mode, log_level=log_level)
        )
        self.action_space = spaces.from_gymnasium(self.env.action_space)
        self.observation_space = spaces.Dict(
            {k: _observation_space(s) for k, s in self.env.observation_space.spaces.items()}
        )
        self.render_mode = render_mode

    def _convert_obs(self, obs: Dict[str, Any]) -> Dict[str, np.ndarray]:
        return {k: np.asarray(v).reshape(self.observation_space[k].shape) for k, v in obs.items()}

    def step(self, action: Any):
        if self._action_type == "discrete" and isinstance(action, np.ndarray):
            action = action.squeeze().item()
        obs, reward, done, truncated, infos = self.env.step(action)
        infos["env_domain"] = "DIAMBRA"
        return self._convert_obs(obs), reward, done or infos.get("env_done", False), truncated, infos

    def render(self, mode: str = "rgb_array", **kwargs):
        return self.env.render()

    def reset(self, *, seed: Optional[int] = None, options: Optional[Dict[str, Any]] = None):
        obs, infos = self.env.reset(seed=seed, options=options)
        infos["env_domain"] = "DIAMBRA"
        return self._convert_obs(obs), infos

    @property
    def unwrapped(self):
        return self

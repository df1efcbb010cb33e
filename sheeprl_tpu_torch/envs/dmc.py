"""DeepMind Control Suite tasks behind the port's env interface (counterpart
of ``DMCWrapper`` in ``sheeprl_tpu/envs/dmc.py``).

The dm_env specs become :class:`~sheeprl_tpu_torch.envs.spaces.Box` spaces;
the action space is normalised to ``[-1, 1]`` and each action is rescaled to
the task's true bounds; observations are the rendered frame under ``rgb``
and the flattened vector observation under ``state``; each step's info
holds the ``discount`` and the physics' ``internal_state``.

``dm_control`` is imported when a wrapper is made, never when this module
is imported, and so is the choice of the offscreen GL backend, which
``MUJOCO_GL`` must name before ``dm_control`` loads MuJoCo's renderer.
"""

from __future__ import annotations

import ctypes.util
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np

from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.wrappers import Env

__all__ = ["DMCWrapper"]


def _pick_gl_backend() -> str:
    """The offscreen GL backend a headless host can load: EGL, then OSMesa,
    else ``off`` (physics and vector observations still work; pixels need a
    renderer). MuJoCo crashes inside PyOpenGL when ``MUJOCO_GL`` names a
    backend whose library is missing, so the choice is made from what the
    loader finds."""
    for backend, lib in (("egl", "EGL"), ("osmesa", "OSMesa")):
        if ctypes.util.find_library(lib):
            return backend
    return "off"


def _spec_to_box(spec_list, dtype) -> spaces.Box:
    """dm_env specs → one flat Box: a bounded spec's bounds, ±inf for an
    unbounded one."""
    from dm_env import specs

    lows, highs = [], []
    for s in spec_list:
        dim = int(np.prod(s.shape))
        if isinstance(s, specs.BoundedArray):
            lows.append(np.broadcast_to(s.minimum, (dim,)).astype(np.float32))
            highs.append(np.broadcast_to(s.maximum, (dim,)).astype(np.float32))
        elif isinstance(s, specs.Array):
            lows.append(np.full(dim, -np.inf, np.float32))
            highs.append(np.full(dim, np.inf, np.float32))
        else:
            raise ValueError(f"Unrecognized spec: {type(s)}")
    return spaces.Box(np.concatenate(lows).astype(dtype), np.concatenate(highs).astype(dtype), dtype=dtype)


def _flatten_obs(obs: Dict[Any, Any]) -> np.ndarray:
    pieces = [np.array([v]) if np.isscalar(v) else np.asarray(v).ravel() for v in obs.values()]
    return np.concatenate(pieces, axis=0)


class DMCWrapper(Env):
    """A dm_control task ``<domain>_<task>`` (``walker_walk``), seeded
    through the task's ``random`` argument so that its episodes' initial
    states are reproducible."""

    def __init__(
        self,
        id: str,  # noqa: A002 — the config's key
        from_pixels: bool = False,
        from_vectors: bool = True,
        height: int = 84,
        width: int = 84,
        camera_id: int = 0,
        task_kwargs: Optional[Dict[Any, Any]] = None,
        environment_kwargs: Optional[Dict[Any, Any]] = None,
        channels_first: bool = True,
        visualize_reward: bool = False,
        seed: Optional[int] = None,
    ):
        if not (from_vectors or from_pixels):
            raise ValueError(
                "'from_vectors' and 'from_pixels' must not be both False: "
                f"got {from_vectors} and {from_pixels} respectively."
            )
        if "DISPLAY" not in os.environ:
            os.environ.setdefault("MUJOCO_GL", _pick_gl_backend())
        if from_pixels and os.environ.get("MUJOCO_GL", "") == "off":
            raise RuntimeError(
                "Pixel observations need an offscreen GL backend, but no EGL or OSMesa library was found on this "
                "host (MUJOCO_GL=off); vector observations (from_vectors=True, from_pixels=False) work without one."
            )
        try:
            from dm_control import suite
        except ImportError as exc:
            raise ModuleNotFoundError("the DMC environments need dm_control, which is not installed") from exc

        domain_name, task_name = id.split("_", 1)
        self._from_pixels, self._from_vectors = from_pixels, from_vectors
        self._height, self._width = height, width
        self._camera_id = camera_id
        self._channels_first = channels_first
        task_kwargs = dict(task_kwargs or {})
        if seed is not None:
            task_kwargs.setdefault("random", seed)
        self.env = suite.load(
            domain_name=domain_name,
            task_name=task_name,
            task_kwargs=task_kwargs,
            visualize_reward=visualize_reward,
            environment_kwargs=environment_kwargs,
        )
        self._true_action_space = _spec_to_box([self.env.action_spec()], np.float32)
        self.action_space = spaces.Box(-1.0, 1.0, self._true_action_space.shape, np.float32)
        reward_space = _spec_to_box([self.env.reward_spec()], np.float32)
        self.reward_range: Tuple[float, float] = (float(reward_space.low.item()), float(reward_space.high.item()))
        obs_space = {}
        if from_pixels:
            shape = (3, height, width) if channels_first else (height, width, 3)
            obs_space["rgb"] = spaces.Box(0, 255, shape, np.uint8)
        if from_vectors:
            obs_space["state"] = _spec_to_box(self.env.observation_spec().values(), np.float64)
        self.observation_space = spaces.Dict(obs_space)
        self.state_space = _spec_to_box(self.env.observation_spec().values(), np.float64)
        self.current_state = None
        self.render_mode = "rgb_array"
        self._true_action_space.seed(seed)
        self.action_space.seed(seed)
        self.observation_space.seed(seed)

    def _get_obs(self, time_step) -> Dict[str, np.ndarray]:
        obs = {}
        if self._from_pixels:
            rgb = self.render(camera_id=self._camera_id)
            obs["rgb"] = rgb.transpose(2, 0, 1).copy() if self._channels_first else rgb
        if self._from_vectors:
            obs["state"] = _flatten_obs(time_step.observation)
        return obs

    def _denormalize_action(self, action: np.ndarray) -> np.ndarray:
        """[-1, 1] → the task's true bounds."""
        action = np.asarray(action, np.float64)
        norm, true = self.action_space, self._true_action_space
        frac = (action - norm.low) / (norm.high - norm.low)
        return (frac * (true.high - true.low) + true.low).astype(np.float32)

    def step(self, action):
        time_step = self.env.step(self._denormalize_action(action))
        reward = time_step.reward or 0.0
        obs = self._get_obs(time_step)
        self.current_state = _flatten_obs(time_step.observation)
        extra = {"discount": time_step.discount, "internal_state": self.env.physics.get_state().copy()}
        return obs, reward, time_step.last(), False, extra

    def reset(self, *, seed: Optional[int] = None, options=None):
        time_step = self.env.reset()
        self.current_state = _flatten_obs(time_step.observation)
        return self._get_obs(time_step), {}

    def render(self, camera_id: Optional[int] = None) -> np.ndarray:
        return self.env.physics.render(height=self._height, width=self._width, camera_id=camera_id or self._camera_id)

    def close(self) -> None:
        self.env.close()

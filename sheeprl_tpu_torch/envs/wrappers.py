"""The env interface and the wrappers the env loop uses (counterpart of
``sheeprl_tpu/envs/wrappers.py`` and of the gymnasium wrappers
``make_env`` applies: ``TransformObservation``, ``TimeLimit``,
``RecordEpisodeStatistics``).

:class:`Env` is gymnasium's five-tuple interface (``reset(seed=,
options=) -> (obs, info)``, ``step(action) -> (obs, reward, terminated,
truncated, info)``) over the port's :mod:`~sheeprl_tpu_torch.envs.spaces`.
:class:`GymnasiumEnv` adapts a gymnasium env to it (gymnasium-backed ids
only; the dummy envs need no gymnasium).
"""

from __future__ import annotations

import time
import warnings
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np

from sheeprl_tpu_torch.envs import spaces

__all__ = [
    "ActionRepeat",
    "Env",
    "GymnasiumEnv",
    "RecordEpisodeStatistics",
    "RestartOnException",
    "RewardAsObservationWrapper",
    "TimeLimit",
    "TransformObservation",
    "Wrapper",
]


class Env:
    """``observation_space``, ``action_space``, ``reset``, ``step``, ``close``."""

    observation_space: spaces.Space
    action_space: spaces.Space

    def reset(self, *, seed: Optional[int] = None, options: Optional[Dict[str, Any]] = None):
        raise NotImplementedError

    def step(self, action):
        raise NotImplementedError

    def render(self):
        return None

    def close(self) -> None:
        pass

    @property
    def unwrapped(self) -> "Env":
        return self


class Wrapper(Env):
    """Delegates to the wrapped env; spaces may be replaced."""

    def __init__(self, env: Env):
        self.env = env
        self.observation_space = env.observation_space
        self.action_space = env.action_space

    def reset(self, *, seed: Optional[int] = None, options: Optional[Dict[str, Any]] = None):
        return self.env.reset(seed=seed, options=options)

    def step(self, action):
        return self.env.step(action)

    def render(self):
        return self.env.render()

    def close(self) -> None:
        self.env.close()

    @property
    def unwrapped(self) -> Env:
        return self.env.unwrapped

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_") or name == "env":
            raise AttributeError(name)
        return getattr(self.env, name)


class GymnasiumEnv(Env):
    """A gymnasium env behind the port's interface, its spaces converted."""

    def __init__(self, env: Any):
        self.env = env
        self.observation_space = spaces.from_gymnasium(env.observation_space)
        self.action_space = spaces.from_gymnasium(env.action_space)

    def reset(self, *, seed: Optional[int] = None, options: Optional[Dict[str, Any]] = None):
        return self.env.reset(seed=seed, options=options)

    def step(self, action):
        return self.env.step(action)

    def render(self):
        return self.env.render()

    def close(self) -> None:
        self.env.close()


class TransformObservation(Wrapper):
    """``fn`` applied to every observation, under a new observation space."""

    def __init__(self, env: Env, fn: Callable[[Any], Any], observation_space: spaces.Space):
        super().__init__(env)
        self._fn = fn
        self.observation_space = observation_space

    def reset(self, *, seed: Optional[int] = None, options: Optional[Dict[str, Any]] = None):
        obs, info = self.env.reset(seed=seed, options=options)
        return self._fn(obs), info

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        return self._fn(obs), reward, terminated, truncated, info


class TimeLimit(Wrapper):
    """Truncate an episode after ``max_episode_steps`` steps."""

    def __init__(self, env: Env, max_episode_steps: int):
        super().__init__(env)
        self._max = int(max_episode_steps)
        self._elapsed = 0

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self._elapsed += 1
        return obs, reward, terminated, truncated or self._elapsed >= self._max, info

    def reset(self, *, seed: Optional[int] = None, options: Optional[Dict[str, Any]] = None):
        self._elapsed = 0
        return self.env.reset(seed=seed, options=options)


class RecordEpisodeStatistics(Wrapper):
    """At an episode's end, ``info["episode"] = {"r": return, "l": length,
    "t": seconds}`` (gymnasium's layout)."""

    def __init__(self, env: Env):
        super().__init__(env)
        self._return, self._length, self._t0 = 0.0, 0, time.perf_counter()

    def reset(self, *, seed: Optional[int] = None, options: Optional[Dict[str, Any]] = None):
        self._return, self._length, self._t0 = 0.0, 0, time.perf_counter()
        return self.env.reset(seed=seed, options=options)

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self._return += float(reward)
        self._length += 1
        if terminated or truncated:
            info = dict(info)
            info["episode"] = {
                "r": self._return,
                "l": self._length,
                "t": round(time.perf_counter() - self._t0, 6),
            }
        return obs, reward, terminated, truncated, info


class ActionRepeat(Wrapper):
    """Repeat each action ``amount`` times, summing rewards; stop early on
    termination."""

    def __init__(self, env: Env, amount: int = 1):
        super().__init__(env)
        if amount <= 0:
            raise ValueError("`amount` should be a positive integer")
        self._amount = int(amount)

    @property
    def action_repeat(self) -> int:
        return self._amount

    def step(self, action):
        total_reward = 0.0
        obs, done, truncated, info = None, False, False, {}
        for _ in range(self._amount):
            obs, reward, done, truncated, info = self.env.step(action)
            total_reward += reward
            if done or truncated:
                break
        return obs, total_reward, done, truncated, info


class RestartOnException(Wrapper):
    """Fault tolerance: rebuild a crashed env from its factory and keep going.

    On an exception during step/reset, rebuild via ``env_fn`` after ``wait``
    seconds and return a reset observation with
    ``info["restart_on_exception"]=True``; more than ``maxfails`` crashes
    within ``window`` seconds re-raises.
    """

    def __init__(
        self,
        env_fn: Callable[[], Env],
        exceptions: Union[type, Sequence[type]] = (Exception,),
        window: float = 300,
        maxfails: int = 2,
        wait: float = 20,
    ):
        if not isinstance(exceptions, (tuple, list)):
            exceptions = (exceptions,)
        self._env_fn = env_fn
        self._exceptions = tuple(exceptions)
        self._window = window
        self._maxfails = maxfails
        self._wait = wait
        self._last_fail_time = time.time()
        self._fails = 0
        super().__init__(env_fn())

    def _handle_crash(self, phase: str, e: Exception) -> Tuple[Any, Dict[str, Any]]:
        now = time.time()
        if now > self._last_fail_time + self._window:
            self._last_fail_time = now
            self._fails = 1
        else:
            self._fails += 1
        if self._fails > self._maxfails:
            raise RuntimeError(f"The env crashed too many times: {self._fails}")
        warnings.warn(f"{phase} - Restarting env after crash with {type(e).__name__}: {e}")
        time.sleep(self._wait)
        self.env = self._env_fn()
        obs, info = self.env.reset()
        info["restart_on_exception"] = True
        return obs, info

    def step(self, action):
        try:
            return self.env.step(action)
        except self._exceptions as e:
            obs, info = self._handle_crash("STEP", e)
            return obs, 0.0, False, False, info

    def reset(self, *, seed: Optional[int] = None, options: Optional[Dict[str, Any]] = None):
        try:
            return self.env.reset(seed=seed, options=options)
        except self._exceptions as e:
            return self._handle_crash("RESET", e)


class RewardAsObservationWrapper(Wrapper):
    """Expose the scalar reward as a ``reward`` observation key."""

    def __init__(self, env: Env):
        super().__init__(env)
        reward_space = spaces.Box(-np.inf, np.inf, (1,), np.float32)
        if isinstance(env.observation_space, spaces.Dict):
            self.observation_space = spaces.Dict({"reward": reward_space, **dict(env.observation_space.spaces)})
        else:
            self.observation_space = spaces.Dict({"obs": env.observation_space, "reward": reward_space})

    def _convert(self, obs: Any, reward: Union[float, np.ndarray]) -> Dict[str, Any]:
        reward_obs = np.asarray(reward, dtype=np.float32).reshape(-1)
        if isinstance(obs, dict):
            obs["reward"] = reward_obs
            return obs
        return {"obs": obs, "reward": reward_obs}

    def step(self, action):
        obs, reward, done, truncated, info = self.env.step(action)
        return self._convert(obs, reward), reward, done, truncated, info

    def reset(self, *, seed: Optional[int] = None, options: Optional[Dict[str, Any]] = None):
        obs, info = self.env.reset(seed=seed, options=options)
        return self._convert(obs, 0.0), info

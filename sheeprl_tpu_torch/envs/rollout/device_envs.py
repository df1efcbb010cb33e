"""Environments on the device (counterpart of
``sheeprl_tpu/envs/rollout/jax_envs.py``): ``CartPole-v1`` and
``Pendulum-v1`` as batched step functions over an explicit state.

A :class:`DeviceEnv` steps ``n`` envs at once on one device. Its state is a
dict of tensors (the physics in float64, as gymnasium keeps it in Python
and numpy floats, and the ``elapsed`` step count, so the time limit is part
of the state). Its randomness is explicit: :meth:`DeviceEnv.reset` and
:meth:`DeviceEnv.sample_action` take uniform draws in [0, 1) as tensors
(:meth:`DeviceEnv.reset_noise` and :meth:`DeviceEnv.action_noise` draw them
from a ``torch.Generator``), so a captured graph that steps the envs holds
no random number generator. The dynamics are gymnasium 1.x's
``classic_control`` ones in its order of operations, with its float32
action arithmetic where numpy does it in float32 (Pendulum's ``3·u`` and
``0.001·u²``); the observation is cast to float32 as gymnasium does.

Observations are one ``"state"`` vector (a Dict space with one MLP key), as
the wrapper pipeline builds them for the vector-obs algorithms. Brax's envs
are not ported: neither machine has brax.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.envs import spaces

__all__ = ["CartPole", "DeviceEnv", "Pendulum", "device_env_ids", "make_device_env"]

State = Dict[str, torch.Tensor]


class DeviceEnv:
    """``n`` envs of one kind on ``device``: ``reset(uniform) -> (state,
    obs)``, ``step(state, action) -> (state, obs, reward, terminated,
    truncated)`` with obs float32 ``[n, obs_dim]``, reward float64 ``[n]``,
    the flags bool ``[n]``."""

    observation_space: spaces.Dict
    action_space: spaces.Space
    #: uniforms a reset of one env takes
    reset_width: int

    def __init__(self, n_envs: int, device, max_episode_steps: Optional[int] = None):
        self.n_envs = int(n_envs)
        self.device = torch.device(device)
        if max_episode_steps is not None and int(max_episode_steps) > 0:
            self.max_episode_steps = int(max_episode_steps)

    @property
    def obs_dim(self) -> int:
        return int(np.prod(self.observation_space["state"].shape))

    @property
    def action_dim(self) -> int:
        return int(np.prod(self.action_space.shape)) if self.action_space.shape else 1

    def reset_noise(self, generator: torch.Generator, lead: Tuple[int, ...] = ()) -> torch.Tensor:
        """Uniforms for ``lead`` resets of the batch: ``[*lead, n, reset_width]`` float64."""
        return torch.rand(lead + (self.n_envs, self.reset_width), generator=generator, dtype=torch.float64,
                          device=self.device)

    def action_noise(self, generator: torch.Generator, lead: Tuple[int, ...] = ()) -> torch.Tensor:
        """Uniforms for ``lead`` random actions of the batch: ``[*lead, n, action_dim]`` float32."""
        return torch.rand(lead + (self.n_envs, self.action_dim), generator=generator, device=self.device)

    def reset(self, uniform: torch.Tensor) -> Tuple[State, torch.Tensor]:
        raise NotImplementedError

    def step(self, state: State, action: torch.Tensor):
        raise NotImplementedError

    def sample_action(self, uniform: torch.Tensor) -> torch.Tensor:
        """A uniform random action per env, float32 ``[n, action_dim]``."""
        raise NotImplementedError

    def _elapsed(self, state: State) -> Tuple[torch.Tensor, torch.Tensor]:
        elapsed = state["elapsed"] + 1
        return elapsed, elapsed >= self.max_episode_steps


class CartPole(DeviceEnv):
    """``CartPole-v1``: Euler steps of 0.02 s, termination at |x| > 2.4 or
    |θ| > 12°, reward 1 on every step (the terminal one too: a done env is
    reset in the same step), truncation at 500 steps, reset state uniform in
    (-0.05, 0.05)⁴. Actions are 0 or 1 (float32 ``[n, 1]``)."""

    GRAVITY = 9.8
    MASSCART = 1.0
    MASSPOLE = 0.1
    TOTAL_MASS = MASSPOLE + MASSCART
    LENGTH = 0.5  # half the pole's length
    POLEMASS_LENGTH = MASSPOLE * LENGTH
    FORCE_MAG = 10.0
    TAU = 0.02
    THETA_THRESHOLD = 12 * 2 * math.pi / 360
    X_THRESHOLD = 2.4
    reset_width = 4
    max_episode_steps = 500

    def __init__(self, n_envs: int, device, max_episode_steps: Optional[int] = None):
        super().__init__(n_envs, device, max_episode_steps)
        high = np.array([self.X_THRESHOLD * 2, np.inf, self.THETA_THRESHOLD * 2, np.inf], dtype=np.float32)
        self.observation_space = spaces.Dict({"state": spaces.Box(-high, high, (4,), np.float32)})
        self.action_space = spaces.Discrete(2)

    def reset(self, uniform: torch.Tensor) -> Tuple[State, torch.Tensor]:
        phys = -0.05 + 0.1 * uniform
        elapsed = torch.zeros(uniform.shape[:-1], dtype=torch.int64, device=uniform.device)
        return {"phys": phys, "elapsed": elapsed}, phys.float()

    def step(self, state: State, action: torch.Tensor):
        x, x_dot, theta, theta_dot = state["phys"].unbind(-1)
        force = torch.where(action.reshape(-1) == 1, self.FORCE_MAG, -self.FORCE_MAG).double()
        costheta = torch.cos(theta)
        sintheta = torch.sin(theta)
        temp = (force + self.POLEMASS_LENGTH * torch.square(theta_dot) * sintheta) / self.TOTAL_MASS
        thetaacc = (self.GRAVITY * sintheta - costheta * temp) / (
            self.LENGTH * (4.0 / 3.0 - self.MASSPOLE * torch.square(costheta) / self.TOTAL_MASS)
        )
        xacc = temp - self.POLEMASS_LENGTH * thetaacc * costheta / self.TOTAL_MASS
        x = x + self.TAU * x_dot
        x_dot = x_dot + self.TAU * xacc
        theta = theta + self.TAU * theta_dot
        theta_dot = theta_dot + self.TAU * thetaacc
        phys = torch.stack([x, x_dot, theta, theta_dot], dim=-1)
        elapsed, truncated = self._elapsed(state)
        terminated = (
            (x < -self.X_THRESHOLD) | (x > self.X_THRESHOLD)
            | (theta < -self.THETA_THRESHOLD) | (theta > self.THETA_THRESHOLD)
        )
        reward = torch.ones_like(x)
        return {"phys": phys, "elapsed": elapsed}, phys.float(), reward, terminated, truncated

    def sample_action(self, uniform: torch.Tensor) -> torch.Tensor:
        return torch.clamp(torch.floor(uniform * 2.0), max=1.0)


class Pendulum(DeviceEnv):
    """``Pendulum-v1``: torque in [-2, 2], never terminates, truncation at
    200 steps; obs ``[cos θ, sin θ, θ̇]``; reset θ uniform in [-π, π] and θ̇
    in [-1, 1]."""

    MAX_SPEED = 8.0
    MAX_TORQUE = 2.0
    DT = 0.05
    G = 10.0
    M = 1.0
    L = 1.0
    reset_width = 2
    max_episode_steps = 200

    def __init__(self, n_envs: int, device, max_episode_steps: Optional[int] = None):
        super().__init__(n_envs, device, max_episode_steps)
        high = np.array([1.0, 1.0, self.MAX_SPEED], dtype=np.float32)
        self.observation_space = spaces.Dict({"state": spaces.Box(-high, high, (3,), np.float32)})
        self.action_space = spaces.Box(-self.MAX_TORQUE, self.MAX_TORQUE, (1,), np.float32)
        # made here: a tensor from host values cannot be made inside a captured graph
        self._reset_high = torch.tensor([math.pi, 1.0], dtype=torch.float64, device=self.device)

    @staticmethod
    def _obs(th: torch.Tensor, thdot: torch.Tensor) -> torch.Tensor:
        return torch.stack([torch.cos(th), torch.sin(th), thdot], dim=-1).float()

    def reset(self, uniform: torch.Tensor) -> Tuple[State, torch.Tensor]:
        high = self._reset_high
        th, thdot = (-high + (high - -high) * uniform).unbind(-1)
        elapsed = torch.zeros(th.shape, dtype=torch.int64, device=uniform.device)
        return {"th": th, "thdot": thdot, "elapsed": elapsed}, self._obs(th, thdot)

    def step(self, state: State, action: torch.Tensor):
        th, thdot = state["th"], state["thdot"]
        u = torch.clamp(action.reshape(action.shape[0], -1)[:, 0].float(), -self.MAX_TORQUE, self.MAX_TORQUE)
        norm_th = torch.remainder(th + math.pi, 2 * math.pi) - math.pi
        costs = norm_th**2 + 0.1 * thdot**2 + (0.001 * u**2).double()
        torque = (3.0 / (self.M * self.L**2) * u).double()  # float32 in numpy too
        newthdot = thdot + (3 * self.G / (2 * self.L) * torch.sin(th) + torque) * self.DT
        newthdot = torch.clamp(newthdot, -self.MAX_SPEED, self.MAX_SPEED)
        newth = th + newthdot * self.DT
        elapsed, truncated = self._elapsed(state)
        terminated = torch.zeros_like(truncated)
        new_state = {"th": newth, "thdot": newthdot, "elapsed": elapsed}
        return new_state, self._obs(newth, newthdot), -costs, terminated, truncated

    def sample_action(self, uniform: torch.Tensor) -> torch.Tensor:
        return -self.MAX_TORQUE + (2 * self.MAX_TORQUE) * uniform


_NATIVE: Dict[str, Callable[..., DeviceEnv]] = {"CartPole-v1": CartPole, "Pendulum-v1": Pendulum}


def device_env_ids() -> Tuple[str, ...]:
    """The ids ``env.backend=jax`` serves."""
    return tuple(sorted(_NATIVE))


def make_device_env(env_id: str, n_envs: int, device, max_episode_steps: Optional[int] = None) -> DeviceEnv:
    """``env.id`` → its device env of ``n_envs`` on ``device``;
    ``max_episode_steps`` (None or ≤ 0: the gymnasium id's limit) sets the
    truncation. A ``brax/<name>`` id and any other id raise."""
    if env_id in _NATIVE:
        return _NATIVE[env_id](n_envs, device, max_episode_steps)
    if str(env_id).startswith("brax/"):
        raise NotImplementedError(
            f"env.backend=jax with id {env_id!r}: the JAX package adapts Brax's envs, and brax is on neither "
            f"machine, so the port has no adapter; its device envs are {sorted(_NATIVE)}"
        )
    raise ValueError(
        f"env.backend=jax cannot serve env.id={env_id!r}: device dynamics exist for {sorted(_NATIVE)}; drop "
        "env.backend=jax to run it through the Python vector-env plane"
    )

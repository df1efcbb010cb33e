"""Collection bursts on the device (counterpart of ``JaxRolloutEngine`` in
``sheeprl_tpu/envs/rollout/engine.py``).

One :meth:`RolloutEngine.collect` call runs a whole burst of ``K`` steps of
``n`` device envs: the action (the policy's, or a uniform random one), the
env step, the ``SAME_STEP`` auto-reset of the envs that ended, and the
append of the burst's ``K`` transition rows to the device ring at its write
head (:func:`~sheeprl_tpu_torch.data.device_ring.scatter_append`). On the
card the burst is captured once per ``(K, random or policy)`` as one CUDA
graph (:class:`~sheeprl_tpu_torch.train.graphs.CapturedStep`) and replayed,
so the host launches one graph a burst and reads nothing back but the
episode statistics. On the CPU it runs eagerly.

The rows are the flat SAC layout (``observations``, ``actions``,
``rewards``, ``dones`` and, with ``store_next_obs``, ``next_observations``),
as the Python plane's loop stores them: ``next_observations`` is the
pre-reset observation of the step (the ``final_obs`` of an env that ended),
while the carried observation is the reset one.

The noise discipline follows the JAX engine: one action draw a step for the
whole batch (the policy's standard normals, or the random actions'
uniforms), then the per-env reset draws. A burst's draws come from the
engine's ``torch.Generator`` before its replay, into the graph's static
buffers (:meth:`RolloutEngine.draw_noise`); a test gives its own.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.data.device_ring import DeviceRingTransitions, scatter_append
from sheeprl_tpu_torch.envs.rollout.device_envs import DeviceEnv
from sheeprl_tpu_torch.obs.counters import add_rollout_burst
from sheeprl_tpu_torch.train.graphs import CapturedStep

__all__ = ["RolloutEngine"]

#: ``policy(obs [n, obs_dim], eps [n, action_dim]) -> actions [n, action_dim]``
Policy = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _where_done(done: torch.Tensor, if_done: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
    return torch.where(done.reshape(done.shape + (1,) * (if_done.dim() - done.dim())), if_done, other)


class _Burst:
    """One captured burst length and action kind, over static noise buffers."""

    def __init__(self, engine: "RolloutEngine", length: int, random_actions: bool):
        self.length = int(length)
        self.random_actions = bool(random_actions)
        shape = (self.length, engine.n_envs, engine.env.action_dim)
        self.noise = {
            "actions": torch.zeros(shape, device=engine.device),
            "reset": torch.zeros((self.length, engine.n_envs, engine.env.reset_width), dtype=torch.float64,
                                 device=engine.device),
        }
        self.step = CapturedStep(lambda: engine._burst(self.length, self.random_actions, self.noise), engine.device,
                                 name="rollout")


class RolloutEngine:
    """The env batch's state and the captured bursts over it.

    ``policy`` acts on the whole ``[n, obs_dim]`` batch from the standard
    normals it is given (None: only random bursts). With a ``ring`` (a
    :class:`~sheeprl_tpu_torch.data.device_ring.DeviceRingTransitions` on the
    engine's device) each burst appends its rows there and returns its
    statistics; without one it returns the stacked rows too."""

    def __init__(
        self,
        env: DeviceEnv,
        generator: torch.Generator,
        policy: Optional[Policy] = None,
        ring: Optional[DeviceRingTransitions] = None,
        store_next_obs: bool = True,
    ):
        self.env = env
        self.n_envs = env.n_envs
        self.device = env.device
        self.generator = generator
        self.ring = ring
        self.store_next_obs = bool(store_next_obs)
        self._policy = policy
        self._bursts: Dict[Tuple[int, bool], _Burst] = {}
        self._carry: Optional[Dict[str, Any]] = None
        #: bursts run and env steps taken in them (each env's step counts once)
        self.bursts = 0
        self.env_steps = 0
        if ring is not None:
            ring.allocate(self.example_rows())

    def example_rows(self) -> Dict[str, torch.Tensor]:
        """Zero ``[n, ...]`` rows in the stored layout."""
        n, obs_dim, act_dim = self.n_envs, self.env.obs_dim, self.env.action_dim
        rows = {
            "observations": torch.zeros((n, obs_dim)),
            "actions": torch.zeros((n, act_dim)),
            "rewards": torch.zeros((n, 1)),
            "dones": torch.zeros((n, 1)),
        }
        if self.store_next_obs:
            rows["next_observations"] = torch.zeros((n, obs_dim))
        return rows

    def reset(self, uniform: Optional[torch.Tensor] = None) -> None:
        """(Re)start every env from ``uniform`` (drawn from the generator when
        None); the episode accumulators start at zero. The carried tensors
        keep their addresses across resets once they exist."""
        if uniform is None:
            uniform = self.env.reset_noise(self.generator)
        with torch.no_grad():
            state, obs = self.env.reset(uniform)
        carry = {"state": {k: v.clone() for k, v in state.items()}, "obs": obs.clone(),
                 "ep_ret": torch.zeros(self.n_envs, dtype=torch.float64, device=self.device),
                 "ep_len": torch.zeros(self.n_envs, dtype=torch.int64, device=self.device)}
        if self._carry is None:
            self._carry = carry
            return
        for k, v in carry.items():
            if isinstance(v, dict):
                for kk, vv in v.items():
                    self._carry[k][kk].copy_(vv)
            else:
                self._carry[k].copy_(v)

    def draw_noise(self, length: int, random_actions: bool) -> Dict[str, torch.Tensor]:
        """A burst's draws from the engine's generator: the actions' (standard
        normals for the policy, uniforms for random actions), then the resets'."""
        lead = (int(length),)
        if random_actions:
            actions = self.env.action_noise(self.generator, lead)
        else:
            actions = torch.randn(lead + (self.n_envs, self.env.action_dim), generator=self.generator,
                                  device=self.device)
        return {"actions": actions, "reset": self.env.reset_noise(self.generator, lead)}

    @torch.no_grad()
    def _burst(self, length: int, random_actions: bool, noise: Dict[str, torch.Tensor]):
        """The burst's body: reads and writes the carry and the ring in place."""
        env, carry = self.env, self._carry
        state = dict(carry["state"])
        obs, ep_ret, ep_len = carry["obs"], carry["ep_ret"], carry["ep_len"]
        n = self.n_envs
        rows, stats = [], []
        for t in range(length):
            if random_actions:
                actions = env.sample_action(noise["actions"][t])
            else:
                actions = self._policy(obs, noise["actions"][t])
            actions = actions.reshape(n, -1).float()
            state2, nobs, reward, terminated, truncated = env.step(state, actions)
            done = terminated | truncated
            row = {"observations": obs, "actions": actions, "rewards": reward.float().reshape(n, 1),
                   "dones": done.float().reshape(n, 1)}
            if self.store_next_obs:
                row["next_observations"] = nobs  # the pre-reset observation: SAME_STEP's final_obs
            rows.append(row)
            reset_state, reset_obs = env.reset(noise["reset"][t])
            state = {k: _where_done(done, reset_state[k], v) for k, v in state2.items()}
            obs = _where_done(done, reset_obs, nobs)
            ep_ret = ep_ret + reward
            ep_len = ep_len + 1
            stats.append((reward.float(), done, ep_ret.float(), ep_len))
            ep_ret = torch.where(done, torch.zeros_like(ep_ret), ep_ret)
            ep_len = torch.where(done, torch.zeros_like(ep_len), ep_len)
        stacked = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
        if self.ring is not None:
            scatter_append(self.ring.buffers, self.ring.pos, stacked, self.ring.buffer_size)
            self.ring.pos.copy_(torch.remainder(self.ring.pos + length, self.ring.buffer_size))
        for k, v in state.items():
            carry["state"][k].copy_(v)
        carry["obs"].copy_(obs)
        carry["ep_ret"].copy_(ep_ret)
        carry["ep_len"].copy_(ep_len)
        out = tuple(torch.stack([s[i] for s in stats]) for i in range(4))
        return out if self.ring is not None else (stacked, out)

    def collect(self, length: int, random_actions: bool = False, noise: Optional[Dict[str, torch.Tensor]] = None):
        """Run one burst of ``length`` steps. Returns the per-step ``(rewards,
        dones, episode returns, episode lengths)``, each ``[length, n]``
        device tensors (a captured burst's static outputs: the next replay
        overwrites them); without a ring, ``(rows, stats)``. ``noise`` (a
        :meth:`draw_noise` dict) replaces the generator's draws."""
        if self._carry is None:
            self.reset()
        if not random_actions and self._policy is None:
            raise ValueError("this RolloutEngine has no policy: pass random_actions=True or build it with policy=...")
        key = (int(length), bool(random_actions))
        burst = self._bursts.get(key)
        if burst is None:
            burst = self._bursts[key] = _Burst(self, *key)
        if noise is None:
            noise = self.draw_noise(*key)
        for k, v in burst.noise.items():
            v.copy_(noise[k])
        out = burst.step()
        if self.ring is not None:
            self.ring.advance(length, self.example_rows())
        self.bursts += 1
        self.env_steps += int(length) * self.n_envs
        add_rollout_burst(act_dispatches=1, jax_steps=int(length) * self.n_envs)
        return out

    @property
    def graphs(self):
        """The captured bursts' :class:`CapturedStep` s, by ``(length, random)``."""
        return {k: b.step for k, b in self._bursts.items()}


def host_rows(rows: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A burst's stacked rows as numpy (tests, and the engine without a ring)."""
    return {k: v.detach().cpu().numpy() for k, v in rows.items()}

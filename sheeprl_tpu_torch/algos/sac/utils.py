"""SAC helpers (counterpart of ``sheeprl_tpu/algos/sac/utils.py``): the
metric allow-list, the vector-obs concatenation and the greedy test
episode."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["AGGREGATOR_KEYS", "concat_obs", "test"]

#: the metrics the training run updates; the CLI drops any other aggregator key
AGGREGATOR_KEYS = {
    "Rewards/rew_avg",
    "Game/ep_len_avg",
    "Loss/value_loss",
    "Loss/policy_loss",
    "Loss/alpha_loss",
}


def concat_obs(obs: Dict[str, np.ndarray], mlp_keys, n_envs: int) -> np.ndarray:
    """The vector keys, concatenated into one float32 ``[n_envs, obs_dim]``."""
    return np.concatenate([np.asarray(obs[k], np.float32).reshape(n_envs, -1) for k in mlp_keys], axis=-1)


def test(act: Callable[[Dict[str, np.ndarray]], np.ndarray], fabric, cfg, log_dir: Optional[str],
         device_env: bool = False) -> Tuple[float, int]:
    """One greedy episode: ``act(obs dict of [1, ...] arrays) -> [1, A]``
    actions. On the Python plane the env is the train-time factory's (seeded
    ``cfg.seed``); with ``device_env`` (``env.backend=jax``) it is the
    run's device env on ``fabric.device``, reset from a generator seeded
    ``cfg.seed``, so the card needs no gymnasium. Returns ``(cumulative
    reward, steps)``; logs ``Test/cumulative_reward``."""
    cumulative, steps, done = 0.0, 0, False
    if device_env:
        from sheeprl_tpu_torch.envs.rollout import make_device_env

        env = make_device_env(cfg.env.id, 1, fabric.device, cfg.env.max_episode_steps)
        generator = torch.Generator(device=fabric.device).manual_seed(int(cfg.seed))
        state, obs_t = env.reset(env.reset_noise(generator))
        while not done:
            action = act({"state": obs_t.cpu().numpy()})
            state, obs_t, reward, terminated, truncated = env.step(
                state, torch.as_tensor(np.asarray(action, np.float32), device=fabric.device).reshape(1, -1)
            )
            done = bool(terminated[0] or truncated[0]) or bool(cfg.dry_run)
            cumulative += float(reward[0])
            steps += 1
    else:
        from sheeprl_tpu_torch.envs.vector import make_eval_env

        env = make_eval_env(cfg, log_dir)
        o = env.reset(seed=cfg.seed)[0]
        while not done:
            action = act({k: np.asarray(v)[None] for k, v in o.items()})
            o, reward, terminated, truncated, _ = env.step(np.asarray(action).reshape(env.action_space.shape))
            done = bool(terminated or truncated) or bool(cfg.dry_run)
            cumulative += float(reward)
            steps += 1
        env.close()
    fabric.print("Test - Reward:", cumulative)
    if cfg.metric.log_level > 0 and getattr(fabric, "logger", None) is not None:
        fabric.logger.log_metrics({"Test/cumulative_reward": cumulative}, 0)
    return cumulative, steps

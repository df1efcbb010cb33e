"""Observation helpers and the greedy test episode (counterpart of
``prepare_obs``, ``normalize_obs_jnp`` and ``test`` in
``sheeprl_tpu/algos/dreamer_v3/utils.py``)."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["normalize_obs", "prepare_obs", "test"]


def prepare_obs(
    obs: Dict[str, np.ndarray], cnn_keys: Sequence[str], mlp_keys: Sequence[str], n_envs: int
) -> Dict[str, np.ndarray]:
    """Host-side obs dict → arrays shaped for the models: cnn keys keep their
    dtype as ``[n, C, H, W]`` (frame stacks folded into C), mlp keys become
    float32 ``[n, -1]``."""
    out = {}
    for k in cnn_keys:
        v = np.asarray(obs[k])
        out[k] = v.reshape(n_envs, -1, *v.shape[-2:])
    for k in mlp_keys:
        out[k] = np.asarray(obs[k]).reshape(n_envs, -1).astype(np.float32)
    return out


def normalize_obs(
    obs: Dict[str, np.ndarray], cnn_keys: Sequence[str], device: torch.device
) -> Dict[str, torch.Tensor]:
    """Copy to ``device`` and scale uint8 pixels to [0, 1] there."""
    out = {}
    for k, v in obs.items():
        t = torch.as_tensor(np.ascontiguousarray(v)).to(device, non_blocking=True).float()
        out[k] = t / 255.0 if k in cnn_keys else t
    return out


def test(
    player_fns: Dict[str, Any],
    fabric,
    cfg,
    log_dir: Optional[str],
    test_name: str = "",
    normalize_fn: Optional[Callable] = None,
) -> Tuple[float, int]:
    """One greedy episode on a fresh env seeded ``cfg.seed`` (the posterior
    still sampled, from a generator seeded ``cfg.seed``). Returns
    ``(cumulative reward, steps)``."""
    from sheeprl_tpu_torch.envs.spaces import Box
    from sheeprl_tpu_torch.envs.vector import make_eval_env

    normalize_fn = normalize_obs if normalize_fn is None else normalize_fn
    env = make_eval_env(cfg, log_dir, prefix="test" + (f"_{test_name}" if test_name else ""))
    cnn_keys, mlp_keys = list(cfg.cnn_keys.encoder), list(cfg.mlp_keys.encoder)
    device = fabric.device
    generator = torch.Generator(device=device).manual_seed(int(cfg.seed))
    obs = env.reset(seed=cfg.seed)[0]
    state = player_fns["init_states"](1)
    done, cumulative_rew, steps = False, 0.0, 0
    while not done:
        norm = normalize_fn(prepare_obs(obs, cnn_keys, mlp_keys, 1), cnn_keys, device)
        actions, state = player_fns["greedy_action"](state, norm, generator)
        if isinstance(env.action_space, Box):
            real_actions = np.concatenate([a.cpu().numpy() for a in actions], -1)
        else:
            real_actions = np.array([a.argmax(dim=-1).cpu().numpy() for a in actions])
        obs, reward, done, truncated, _ = env.step(real_actions.reshape(env.action_space.shape))
        done = done or truncated or cfg.dry_run
        cumulative_rew += float(reward)
        steps += 1
    fabric.print("Test - Reward:", cumulative_rew)
    if cfg.metric.log_level > 0 and getattr(fabric, "logger", None) is not None:
        fabric.logger.log_metrics({"Test/cumulative_reward": cumulative_rew}, 0)
    env.close()
    return cumulative_rew, steps

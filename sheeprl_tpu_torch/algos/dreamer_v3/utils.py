"""DreamerV3 helpers (counterpart of ``AGGREGATOR_KEYS``, ``init_moments``,
``update_moments``, ``compute_lambda_values``, ``prepare_obs``,
``normalize_obs_jnp`` and ``test`` in ``sheeprl_tpu/algos/dreamer_v3/utils.py``).

:func:`update_moments` is the return normaliser's percentile EMA, with the
5%/95% percentiles from ``torch.quantile`` (linear interpolation, as
``jnp.quantile``): device operations only, so that it replays from a CUDA
graph. In a data-parallel world the percentiles are taken over the values
gathered from every rank (``obs.dist.comms.all_gather``, the JAX step's
``lax.all_gather`` over the mesh); outside one over this rank's."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.obs.dist.comms import all_gather

__all__ = [
    "AGGREGATOR_KEYS",
    "compute_lambda_values",
    "init_moments",
    "normalize_obs",
    "normalize_obs_tensors",
    "prepare_obs",
    "test",
    "update_moments",
]

#: the metrics the training run updates; the CLI drops any other aggregator key
AGGREGATOR_KEYS = {
    "Rewards/rew_avg",
    "Game/ep_len_avg",
    "Loss/world_model_loss",
    "Loss/value_loss",
    "Loss/policy_loss",
    "Loss/observation_loss",
    "Loss/reward_loss",
    "Loss/state_loss",
    "Loss/continue_loss",
    "State/kl",
    "State/post_entropy",
    "State/prior_entropy",
    "Params/exploration_amount",
    "Grads/world_model",
    "Grads/actor",
    "Grads/critic",
    "User/LambdaValues",
    "User/Advantages",
    "User/Entropy",
    "User/PredictedRewards",
    "User/PredictedValues",
    "User/DynLoss",
    "User/ReprLoss",
}


def init_moments(device=None) -> Dict[str, torch.Tensor]:
    return {"low": torch.zeros((), device=device), "high": torch.zeros((), device=device)}


def update_moments(
    state: Dict[str, torch.Tensor],
    x: torch.Tensor,
    decay: float = 0.99,
    max_: float = 1e8,
    percentile_low: float = 0.05,
    percentile_high: float = 0.95,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
    """EMA of the ``percentile_low``/``percentile_high`` quantiles of ``x``.
    Returns ``(new_state, offset, invscale)``, all detached; ``state`` is
    left as it is. In a data-parallel world the quantiles are the whole
    world's: ``x`` is gathered from every rank first."""
    x = all_gather(x.detach().reshape(-1)).reshape(-1)
    low = torch.quantile(x, percentile_low)
    high = torch.quantile(x, percentile_high)
    new_low = decay * state["low"] + (1 - decay) * low
    new_high = decay * state["high"] + (1 - decay) * high
    invscale = torch.clamp_min(new_high - new_low, 1.0 / max_)
    return {"low": new_low, "high": new_high}, new_low, invscale


def compute_lambda_values(
    rewards: torch.Tensor, values: torch.Tensor, continues: torch.Tensor, lmbda: float = 0.95
) -> torch.Tensor:
    """TD(λ) returns over ``[H, ...]``, ``continues`` already multiplied by
    γ, each row's value the one that follows its reward: ``lv_t = r_t +
    c_t·((1−λ)·v_t + λ·lv_{t+1})``, bootstrapped from the last value."""
    interm = rewards + continues * values * (1 - lmbda)
    nxt = values[-1]
    out = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        nxt = interm[t] + continues[t] * lmbda * nxt
        out.append(nxt)
    return torch.stack(out[::-1])


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
    return normalize_obs_tensors(
        {k: torch.as_tensor(np.ascontiguousarray(v)).to(device, non_blocking=True) for k, v in obs.items()}, cnn_keys
    )


def normalize_obs_tensors(obs: Dict[str, torch.Tensor], cnn_keys: Sequence[str]) -> Dict[str, torch.Tensor]:
    """Tensors already on the device → float32, uint8 pixels scaled to [0, 1]."""
    return {k: v.float() / 255.0 if k in cnn_keys else v.float() for k, v in obs.items()}


def test(
    player_fns: Dict[str, Any],
    fabric,
    cfg,
    log_dir: Optional[str],
    test_name: str = "",
    normalize_fn: Optional[Callable] = None,
    sample_actions: bool = False,
) -> Tuple[float, int]:
    """One episode on a fresh env seeded ``cfg.seed``, its noise from a
    generator seeded ``cfg.seed``: greedy (the posterior sampled, the
    actor's mode), or with ``sample_actions`` the exploration step at zero
    exploration (the action sampled too: DreamerV3's test). Returns
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
        if sample_actions:
            actions, state = player_fns["exploration_action"](state, norm, 0.0, generator)
        else:
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

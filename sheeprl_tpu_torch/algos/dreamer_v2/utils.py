"""DreamerV2 helpers (counterpart of ``AGGREGATOR_KEYS``,
``compute_lambda_values`` and ``normalize_obs_jnp`` in
``sheeprl_tpu/algos/dreamer_v2/utils.py``)."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

__all__ = ["AGGREGATOR_KEYS", "compute_lambda_values", "normalize_obs", "normalize_obs_tensors"]

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
    "State/post_entropy",
    "State/prior_entropy",
    "State/kl",
    "Params/exploration_amount",
    "Grads/world_model",
    "Grads/actor",
    "Grads/critic",
}


def normalize_obs(
    obs: Dict[str, np.ndarray], cnn_keys: Sequence[str], device: torch.device
) -> Dict[str, torch.Tensor]:
    """Copy to ``device`` and scale uint8 pixels to [-0.5, 0.5] there."""
    return normalize_obs_tensors(
        {k: torch.as_tensor(np.ascontiguousarray(v)).to(device, non_blocking=True) for k, v in obs.items()}, cnn_keys
    )


def normalize_obs_tensors(obs: Dict[str, torch.Tensor], cnn_keys: Sequence[str]) -> Dict[str, torch.Tensor]:
    """Tensors already on the device → float32, uint8 pixels scaled to [-0.5, 0.5]."""
    return {k: v.float() / 255.0 - 0.5 if k in cnn_keys else v.float() for k, v in obs.items()}


def compute_lambda_values(
    rewards: torch.Tensor,
    values: torch.Tensor,
    continues: torch.Tensor,
    bootstrap: torch.Tensor,
    lmbda: float = 0.95,
) -> torch.Tensor:
    """TD(λ) over ``[H, ...]`` with an explicit bootstrap row ``[1, ...]``:
    ``lv_t = r_t + c_t·((1−λ)·v_{t+1} + λ·lv_{t+1})`` with ``lv_H = bootstrap``."""
    next_values = torch.cat([values[1:], bootstrap], dim=0)
    inputs = rewards + continues * next_values * (1 - lmbda)
    agg = bootstrap[0]
    out = []
    for t in range(inputs.shape[0] - 1, -1, -1):
        agg = inputs[t] + continues[t] * lmbda * agg
        out.append(agg)
    return torch.stack(out[::-1])

"""PPO helpers (counterpart of ``sheeprl_tpu/algos/ppo/utils.py``): the
metric allow-list, observation staging and normalization, and the greedy
test episode (SAC's, over PPO's greedy policy)."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from sheeprl_tpu_torch.algos.sac.utils import test

__all__ = ["AGGREGATOR_KEYS", "normalize_obs", "prepare_obs", "test"]

#: the metrics the training run updates; the CLI drops any other aggregator key
AGGREGATOR_KEYS = {
    "Rewards/rew_avg",
    "Game/ep_len_avg",
    "Loss/value_loss",
    "Loss/policy_loss",
    "Loss/entropy_loss",
}


def normalize_obs(obs: Dict[str, torch.Tensor], cnn_keys: Sequence[str],
                  obs_keys: Sequence[str]) -> Dict[str, torch.Tensor]:
    """uint8 pixels → ``x / 255 − 0.5`` in float32; vector keys to float32."""
    return {k: obs[k].float() / 255.0 - 0.5 if k in cnn_keys else obs[k].float() for k in obs_keys}


def prepare_obs(obs: Dict[str, np.ndarray], cnn_keys: Sequence[str], num_envs: int = 1) -> Dict[str, np.ndarray]:
    """An env observation batch on the host: a frame stack folded into the
    channels of each CNN key (dtype kept), the MLP keys flattened to float32."""
    out = {}
    for k, v in obs.items():
        v = np.asarray(v)
        if k in cnn_keys:
            out[k] = v.reshape(num_envs, -1, *v.shape[-2:])
        else:
            out[k] = v.reshape(num_envs, -1).astype(np.float32)
    return out

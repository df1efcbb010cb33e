"""A2C helpers (counterpart of ``sheeprl_tpu/algos/a2c/utils.py``): PPO's,
with A2C's metric allow-list."""

from __future__ import annotations

from sheeprl_tpu_torch.algos.ppo.utils import normalize_obs, prepare_obs, test

__all__ = ["AGGREGATOR_KEYS", "normalize_obs", "prepare_obs", "test"]

#: the metrics the training run updates; the CLI drops any other aggregator key
AGGREGATOR_KEYS = {
    "Rewards/rew_avg",
    "Game/ep_len_avg",
    "Loss/value_loss",
    "Loss/policy_loss",
}

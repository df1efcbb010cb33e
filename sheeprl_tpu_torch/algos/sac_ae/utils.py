"""SAC-AE helpers (counterpart of ``sheeprl_tpu/algos/sac_ae/utils.py``):
the metric allow-list and the observation pipeline it shares with
DreamerV3 (pixels kept uint8 ``[n, C, H, W]``, the frame stack folded into
the channels, scaled to [0, 1] on the device)."""

from __future__ import annotations

from sheeprl_tpu_torch.algos.dreamer_v3.utils import normalize_obs, normalize_obs_tensors, prepare_obs

__all__ = ["AGGREGATOR_KEYS", "normalize_obs", "normalize_obs_tensors", "prepare_obs"]

#: the metrics the training run updates; the CLI drops any other aggregator key
AGGREGATOR_KEYS = {
    "Rewards/rew_avg",
    "Game/ep_len_avg",
    "Loss/value_loss",
    "Loss/policy_loss",
    "Loss/alpha_loss",
    "Loss/reconstruction_loss",
}

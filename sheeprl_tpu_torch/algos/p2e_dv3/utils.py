"""P2E-DV3 helpers (counterpart of ``sheeprl_tpu/algos/p2e_dv3/utils.py``):
the metric allow-list of both phases, with the per-critic keys of the
default ``intrinsic`` and ``extrinsic`` exploration critics."""

from __future__ import annotations

from sheeprl_tpu_torch.algos.dreamer_v3.utils import AGGREGATOR_KEYS as _DV3_KEYS

__all__ = ["AGGREGATOR_KEYS"]

#: the metrics the exploration and finetuning runs update; the CLI drops any other aggregator key
AGGREGATOR_KEYS = _DV3_KEYS | {
    "Loss/ensemble_loss",
    "Loss/policy_loss_exploration",
    "Loss/policy_loss_task",
    "Loss/value_loss_task",
    "Grads/ensemble",
    "Grads/actor_exploration",
    "Grads/actor_task",
    "Grads/critic_task",
    "Rewards/intrinsic_intrinsic",
    "Values_exploration/predicted_values_intrinsic",
    "Values_exploration/lambda_values_intrinsic",
    "Values_exploration/predicted_values_extrinsic",
    "Values_exploration/lambda_values_extrinsic",
    "Loss/value_loss_exploration_intrinsic",
    "Loss/value_loss_exploration_extrinsic",
}

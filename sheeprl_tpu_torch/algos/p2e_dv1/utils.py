"""P2E-DV1 helpers (counterpart of ``sheeprl_tpu/algos/p2e_dv1/utils.py``):
the metric allow-list of both phases."""

from __future__ import annotations

from sheeprl_tpu_torch.algos.dreamer_v1.utils import AGGREGATOR_KEYS as _DV1_KEYS

__all__ = ["AGGREGATOR_KEYS"]

#: the metrics the exploration and finetuning runs update; the CLI drops any other aggregator key
AGGREGATOR_KEYS = _DV1_KEYS | {
    "Loss/ensemble_loss",
    "Loss/policy_loss_exploration",
    "Loss/value_loss_exploration",
    "Loss/policy_loss_task",
    "Loss/value_loss_task",
    "Rewards/intrinsic",
    "Values_exploration/predicted_values",
    "Values_exploration/lambda_values",
    "Grads/ensemble",
    "Grads/actor_exploration",
    "Grads/critic_exploration",
    "Grads/actor_task",
    "Grads/critic_task",
}

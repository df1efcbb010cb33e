"""DreamerV1 helpers (counterpart of ``sheeprl_tpu/algos/dreamer_v1/utils.py``):
the metric allow-list, the V1 λ-targets, and DreamerV2's observation
scaling (pixels to [-0.5, 0.5])."""

from __future__ import annotations

import torch

from sheeprl_tpu_torch.algos.dreamer_v2.utils import normalize_obs, normalize_obs_tensors

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
    "State/kl",
    "State/post_entropy",
    "State/prior_entropy",
    "Params/exploration_amount",
    "Grads/world_model",
    "Grads/actor",
    "Grads/critic",
}


def compute_lambda_values(
    rewards: torch.Tensor,
    values: torch.Tensor,
    continues: torch.Tensor,
    last_values: torch.Tensor,
    lmbda: float = 0.95,
) -> torch.Tensor:
    """The V1 λ-targets: ``[H, ...]`` inputs give ``[H−1, ...]`` outputs.
    ``lv_t = r_t + c_t·(b_t + λ·lv_{t+1})`` backwards from ``lv_{H−1} = 0``,
    where the bootstrap ``b_t`` is ``(1−λ)·v_{t+1}`` for t < H−2 and the
    whole ``last_values`` at t = H−2 (not DreamerV2's recursion)."""
    horizon = rewards.shape[0]
    next_values = torch.cat([values[1 : horizon - 1] * (1 - lmbda), last_values[None]])
    inputs = rewards[: horizon - 1] + next_values * continues[: horizon - 1]
    agg = torch.zeros_like(values[0])
    out = []
    for t in range(horizon - 2, -1, -1):
        agg = inputs[t] + lmbda * continues[t] * agg
        out.append(agg)
    return torch.stack(out[::-1])

"""SAC losses (counterpart of ``sheeprl_tpu/algos/sac/loss.py``; Eqs. 5, 7
and 17 of https://arxiv.org/abs/1812.05905)."""

from __future__ import annotations

import torch

__all__ = ["critic_loss", "entropy_loss", "policy_loss"]


def policy_loss(alpha: torch.Tensor, logprobs: torch.Tensor, qf_values: torch.Tensor) -> torch.Tensor:
    return ((alpha * logprobs) - qf_values).mean()


def critic_loss(qf_values: torch.Tensor, next_qf_value: torch.Tensor, num_critics: int) -> torch.Tensor:
    """The sum of the members' MSEs against the shared TD target."""
    return sum(((qf_values[..., i : i + 1] - next_qf_value) ** 2).mean() for i in range(num_critics))


def entropy_loss(log_alpha: torch.Tensor, logprobs: torch.Tensor, target_entropy: float) -> torch.Tensor:
    return (-log_alpha * (logprobs + target_entropy)).mean()

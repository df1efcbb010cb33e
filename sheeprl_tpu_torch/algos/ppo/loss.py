"""PPO losses (counterpart of ``sheeprl_tpu/algos/ppo/loss.py``). The clip
coefficient may be a device scalar, so that annealing it changes no
captured graph."""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["entropy_loss", "policy_loss", "reduce", "value_loss"]


def reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    reduction = reduction.lower()
    if reduction == "none":
        return x
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    raise ValueError(f"Unrecognized reduction: {reduction}")


def policy_loss(new_logprobs: torch.Tensor, logprobs: torch.Tensor, advantages: torch.Tensor,
                clip_coef: Union[float, torch.Tensor], reduction: str = "mean") -> torch.Tensor:
    """The clipped surrogate objective (equation 7 of the PPO paper), negated."""
    ratio = torch.exp(new_logprobs - logprobs)
    pg_loss1 = advantages * ratio
    pg_loss2 = advantages * torch.clamp(ratio, 1.0 - clip_coef, 1.0 + clip_coef)
    return reduce(-torch.minimum(pg_loss1, pg_loss2), reduction)


def value_loss(new_values: torch.Tensor, old_values: torch.Tensor, returns: torch.Tensor,
               clip_coef: Union[float, torch.Tensor], clip_vloss: bool, reduction: str = "mean") -> torch.Tensor:
    values_pred = new_values
    if clip_vloss:
        values_pred = old_values + torch.clamp(new_values - old_values, -clip_coef, clip_coef)
    return reduce((values_pred - returns) ** 2, reduction)


def entropy_loss(entropy: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    return reduce(-entropy, reduction)

"""A2C losses (counterpart of ``sheeprl_tpu/algos/a2c/loss.py``): the
advantage-weighted policy gradient, no ratio and no clip, and PPO's value
loss with clipping off."""

from __future__ import annotations

import torch

from sheeprl_tpu_torch.algos.ppo.loss import reduce
from sheeprl_tpu_torch.algos.ppo.loss import value_loss as _ppo_value_loss

__all__ = ["policy_loss", "value_loss"]


def policy_loss(logprobs: torch.Tensor, advantages: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    return reduce(-(advantages * logprobs), reduction)


def value_loss(values: torch.Tensor, returns: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    return _ppo_value_loss(values, values, returns, 0.0, clip_vloss=False, reduction=reduction)

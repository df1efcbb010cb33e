"""DreamerV3 world-model loss (counterpart of
``sheeprl_tpu/algos/dreamer_v3/loss.py``).

The negative log-likelihoods of the observations, the two-hot rewards and
the continues, and the KL balance ``kl_dynamic · max(KL(sg(post) ‖ prior),
free) + kl_representation · max(KL(post ‖ sg(prior)), free)`` with the free
nats applied element-wise, all averaged over ``[T, B]`` once at the end.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from sheeprl_tpu_torch.algos.dreamer_v2.loss import categorical_kl
from sheeprl_tpu_torch.distributions import Bernoulli, Independent, OneHotCategorical

__all__ = ["categorical_kl", "continue_distribution", "reconstruction_loss"]


def reconstruction_loss(
    po: Dict[str, Any],
    observations: Dict[str, torch.Tensor],
    pr: Any,
    rewards: torch.Tensor,
    priors_logits: torch.Tensor,
    posteriors_logits: torch.Tensor,
    kl_dynamic: float = 0.5,
    kl_representation: float = 0.1,
    kl_free_nats: float = 1.0,
    kl_regularizer: float = 1.0,
    pc: Optional[Any] = None,
    continue_targets: Optional[torch.Tensor] = None,
    continue_scale_factor: float = 1.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``priors_logits``/``posteriors_logits``: ``[T, B, S, D]``. Returns
    ``(scalar_loss, metrics)``; the metrics are detached."""
    observation_loss = -sum(po[k].log_prob(observations[k]) for k in po)
    reward_loss = -pr.log_prob(rewards)
    free = float(kl_free_nats)  # a host scalar: no copy to the device inside a captured step
    kl = categorical_kl(posteriors_logits.detach(), priors_logits)
    dyn_loss = kl_dynamic * kl.clamp_min(free)
    repr_loss = kl_representation * categorical_kl(posteriors_logits, priors_logits.detach()).clamp_min(free)
    kl_loss = dyn_loss + repr_loss
    continue_loss = torch.zeros_like(reward_loss)
    if pc is not None and continue_targets is not None:
        continue_loss = continue_scale_factor * -pc.log_prob(continue_targets)
    total = (kl_regularizer * kl_loss + observation_loss + reward_loss + continue_loss).mean()
    metrics = {
        "Loss/world_model_loss": total,
        "Loss/observation_loss": observation_loss.mean(),
        "Loss/reward_loss": reward_loss.mean(),
        "Loss/state_loss": kl_loss.mean(),
        "Loss/continue_loss": continue_loss.mean(),
        "State/kl": kl.mean(),
        "User/DynLoss": dyn_loss.mean(),
        "User/ReprLoss": repr_loss.mean(),
        "State/post_entropy": Independent(OneHotCategorical(logits=posteriors_logits.detach()), 1).entropy().mean(),
        "State/prior_entropy": Independent(OneHotCategorical(logits=priors_logits.detach()), 1).entropy().mean(),
    }
    return total, {k: v.detach() for k, v in metrics.items()}


def continue_distribution(logits: torch.Tensor) -> Independent:
    """Independent Bernoulli over the trailing axis (the continue head)."""
    return Independent(Bernoulli(logits=logits), 1)

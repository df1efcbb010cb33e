"""DreamerV2 world-model loss (counterpart of
``sheeprl_tpu/algos/dreamer_v2/loss.py``).

Gaussian NLL of observations and rewards, the optional Bernoulli continue
NLL, and the KL-balanced categorical state loss
``alpha · KL(sg(post) ‖ prior) + (1 − alpha) · KL(post ‖ sg(prior))`` with
the free-nats clamp applied to the mean (``kl_free_avg``) or element-wise.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from sheeprl_tpu_torch.distributions import Independent, OneHotCategorical, kl_divergence

__all__ = ["categorical_kl", "reconstruction_loss"]


def categorical_kl(p_logits: torch.Tensor, q_logits: torch.Tensor) -> torch.Tensor:
    """KL( Cat(p) ‖ Cat(q) ) summed over the stochastic dim.
    Logits ``[..., S, D]`` → ``[...]``."""
    return kl_divergence(
        Independent(OneHotCategorical(logits=p_logits), 1), Independent(OneHotCategorical(logits=q_logits), 1)
    )


def reconstruction_loss(
    po: Dict[str, Any],
    observations: Dict[str, torch.Tensor],
    pr: Any,
    rewards: torch.Tensor,
    priors_logits: torch.Tensor,
    posteriors_logits: torch.Tensor,
    kl_balancing_alpha: float = 0.8,
    kl_free_nats: float = 0.0,
    kl_free_avg: bool = True,
    kl_regularizer: float = 1.0,
    pc: Optional[Any] = None,
    continue_targets: Optional[torch.Tensor] = None,
    discount_scale_factor: float = 1.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``priors_logits``/``posteriors_logits``: ``[T, B, S, D]``. Returns
    ``(scalar_loss, metrics)``; the metrics are detached."""
    observation_loss = -sum(po[k].log_prob(observations[k]).mean() for k in po)
    reward_loss = -pr.log_prob(rewards).mean()

    lhs = categorical_kl(posteriors_logits.detach(), priors_logits)
    rhs = categorical_kl(posteriors_logits, priors_logits.detach())
    free = torch.tensor(kl_free_nats, dtype=lhs.dtype, device=lhs.device)
    if kl_free_avg:
        loss_lhs = torch.maximum(lhs.mean(), free)
        loss_rhs = torch.maximum(rhs.mean(), free)
    else:
        loss_lhs = torch.maximum(lhs, free).mean()
        loss_rhs = torch.maximum(rhs, free).mean()
    kl_loss = kl_balancing_alpha * loss_lhs + (1 - kl_balancing_alpha) * loss_rhs

    continue_loss = torch.zeros((), dtype=lhs.dtype, device=lhs.device)
    if pc is not None and continue_targets is not None:
        continue_loss = discount_scale_factor * -pc.log_prob(continue_targets).mean()

    total = kl_regularizer * kl_loss + observation_loss + reward_loss + continue_loss
    metrics = {
        "Loss/world_model_loss": total,
        "Loss/observation_loss": observation_loss,
        "Loss/reward_loss": reward_loss,
        "Loss/state_loss": kl_loss,
        "Loss/continue_loss": continue_loss,
        "State/kl": lhs.mean(),
        "State/post_entropy": Independent(OneHotCategorical(logits=posteriors_logits.detach()), 1).entropy().mean(),
        "State/prior_entropy": Independent(OneHotCategorical(logits=priors_logits.detach()), 1).entropy().mean(),
    }
    return total, {k: v.detach() for k, v in metrics.items()}

"""DreamerV1 world-model loss (counterpart of
``sheeprl_tpu/algos/dreamer_v1/loss.py``).

Gaussian NLL of the observations (unit Gaussians over an image's 3
dimensions, a vector's 1) and the rewards, the optional Bernoulli continue
NLL, and ``kl_regularizer · max(free_nats, mean KL(post ‖ prior))`` of the
Gaussian latents: the mean over time and batch is taken first, then the
clamp.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from sheeprl_tpu_torch.distributions import Independent, Normal, kl_divergence

__all__ = ["gaussian_independent", "reconstruction_loss"]


def reconstruction_loss(
    qo: Dict[str, Any],
    observations: Dict[str, torch.Tensor],
    qr: Any,
    rewards: torch.Tensor,
    posteriors_dist: Any,
    priors_dist: Any,
    kl_free_nats: float = 3.0,
    kl_regularizer: float = 1.0,
    qc: Optional[Any] = None,
    continue_targets: Optional[torch.Tensor] = None,
    continue_scale_factor: float = 10.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``posteriors_dist``/``priors_dist``: Independent Normals over ``[T,
    B, S]``. Returns ``(scalar_loss, metrics)``; the metrics are detached."""
    observation_loss = -sum(qo[k].log_prob(observations[k]).mean() for k in qo)
    reward_loss = -qr.log_prob(rewards).mean()
    kl = kl_divergence(posteriors_dist, priors_dist).mean()
    state_loss = kl.clamp_min(float(kl_free_nats))  # a host scalar: nothing copied inside a captured step
    continue_loss = torch.zeros((), dtype=kl.dtype, device=kl.device)
    if qc is not None and continue_targets is not None:
        continue_loss = continue_scale_factor * -qc.log_prob(continue_targets).mean()
    total = kl_regularizer * state_loss + observation_loss + reward_loss + continue_loss
    metrics = {
        "Loss/world_model_loss": total,
        "Loss/observation_loss": observation_loss,
        "Loss/reward_loss": reward_loss,
        "Loss/state_loss": state_loss,
        "Loss/continue_loss": continue_loss,
        "State/kl": kl,
        "State/post_entropy": posteriors_dist.entropy().mean(),
        "State/prior_entropy": priors_dist.entropy().mean(),
    }
    return total, {k: v.detach() for k, v in metrics.items()}


def gaussian_independent(mean: torch.Tensor, std=1.0, ndims: int = 1) -> Independent:
    """A Gaussian of scale ``std`` (a float or a tensor) at ``mean`` over its last ``ndims`` dimensions."""
    return Independent(Normal(mean, std), ndims)

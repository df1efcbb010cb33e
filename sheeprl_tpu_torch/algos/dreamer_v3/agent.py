"""The DreamerV3 actor pieces that DreamerV2 shares (counterpart of
``Actor``, ``resolve_actor_distribution``, ``build_actor_dists``,
``sample_actor_actions`` and ``actor_entropy`` in
``sheeprl_tpu/algos/dreamer_v3/agent.py``).

Discrete actions only: continuous actors (greedy best-of-100 sampling from a
truncated normal) come in a later slice and raise here.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sheeprl_tpu_torch.distributions import OneHotCategoricalStraightThrough
from sheeprl_tpu_torch.models import MLP

__all__ = ["Actor", "actor_entropy", "build_actor_dists", "resolve_actor_distribution", "sample_actor_actions"]

_CONTINUOUS = "continuous actions are not ported yet: only discrete actors are served"


class Actor(nn.Module):
    """Dense trunk plus one Linear head per discrete sub-action. Returns the
    raw head outputs (logits), one tensor per head."""

    def __init__(
        self,
        latent_size: int,
        actions_dim: Sequence[int],
        is_continuous: bool,
        distribution: str = "auto",
        dense_units: int = 1024,
        mlp_layers: int = 5,
        layer_norm: bool = True,
        activation="silu",
        device=None,
    ):
        super().__init__()
        if is_continuous:
            raise NotImplementedError(_CONTINUOUS)
        self.actions_dim = tuple(int(d) for d in actions_dim)
        self.distribution = distribution
        self.mlp = MLP(
            latent_size,
            [dense_units] * mlp_layers,
            activation=activation,
            layer_norm=layer_norm,
            norm_eps=1e-3,
            bias=not layer_norm,
            device=device,
        )
        self.heads = nn.ModuleList(
            nn.Linear(self.mlp.output_dim, dim, device=device) for dim in self.actions_dim
        )

    def forward(self, state: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = self.mlp(state)
        return tuple(head(x).float() for head in self.heads)


def resolve_actor_distribution(distribution: str, is_continuous: bool) -> str:
    dist = (distribution or "auto").lower()
    if dist not in ("auto", "normal", "tanh_normal", "discrete", "trunc_normal"):
        raise ValueError(
            "The distribution must be on of: `auto`, `discrete`, `normal`, "
            f"`tanh_normal` and `trunc_normal`. Found: {dist}"
        )
    if dist == "discrete" and is_continuous:
        raise ValueError("You have choose a discrete distribution but `is_continuous` is true")
    if dist == "auto":
        dist = "trunc_normal" if is_continuous else "discrete"
    return dist


def build_actor_dists(
    pre_dist: Sequence[torch.Tensor],
    is_continuous: bool,
    distribution: str,
    init_std: float = 0.0,
    min_std: float = 0.1,
    unimix: float = 0.01,
) -> List[OneHotCategoricalStraightThrough]:
    """Head outputs → one straight-through categorical per sub-action, with
    an optional uniform mix of the probabilities."""
    if is_continuous:
        raise NotImplementedError(_CONTINUOUS)
    dists = []
    for logits in pre_dist:
        probs = F.softmax(logits, dim=-1)
        if unimix > 0.0:
            probs = (1.0 - unimix) * probs + unimix / probs.shape[-1]
        dists.append(OneHotCategoricalStraightThrough(logits=torch.log(probs)))
    return dists


def sample_actor_actions(
    dists: Sequence[OneHotCategoricalStraightThrough],
    is_continuous: bool,
    generator: Optional[torch.Generator] = None,
    is_training: bool = True,
    gumbels: Optional[Sequence[torch.Tensor]] = None,
) -> List[torch.Tensor]:
    """A straight-through sample per head when training, the mode otherwise.
    ``gumbels`` holds pre-drawn Gumbel(0,1) noise, one tensor per head shaped
    like its logits (the JAX side draws it per head from ``split(key)``);
    without it the noise comes from ``generator``."""
    if is_continuous:
        raise NotImplementedError(_CONTINUOUS)
    if not is_training:
        return [d.mode for d in dists]
    if gumbels is None:
        return [d.rsample(generator) for d in dists]
    return [d.rsample(gumbel=g) for d, g in zip(dists, gumbels)]


def actor_entropy(dists: Sequence[OneHotCategoricalStraightThrough]) -> torch.Tensor:
    """Summed per-head entropy (the discrete actors' closed form)."""
    return sum(d.entropy() for d in dists)

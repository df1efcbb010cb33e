"""Distributions of the DreamerV2 slice (counterpart of ``sheeprl_tpu/distributions``)."""

from sheeprl_tpu_torch.distributions.distributions import (
    Bernoulli,
    Independent,
    Normal,
    OneHotCategorical,
    OneHotCategoricalStraightThrough,
    gumbel_noise,
    kl_divergence,
)

__all__ = [
    "Bernoulli",
    "Independent",
    "Normal",
    "OneHotCategorical",
    "OneHotCategoricalStraightThrough",
    "gumbel_noise",
    "kl_divergence",
]

"""Distributions of the Dreamer slices (counterpart of ``sheeprl_tpu/distributions``)."""

from sheeprl_tpu_torch.distributions.distributions import (
    Bernoulli,
    Independent,
    MSEDistribution,
    Normal,
    OneHotCategorical,
    OneHotCategoricalStraightThrough,
    SymlogDistribution,
    TwoHotEncodingDistribution,
    gumbel_noise,
    kl_divergence,
    symexp,
    symlog,
)

__all__ = [
    "Bernoulli",
    "Independent",
    "MSEDistribution",
    "Normal",
    "OneHotCategorical",
    "OneHotCategoricalStraightThrough",
    "SymlogDistribution",
    "TwoHotEncodingDistribution",
    "gumbel_noise",
    "kl_divergence",
    "symexp",
    "symlog",
]

"""Distributions of the Dreamer slices (counterpart of ``sheeprl_tpu/distributions``)."""

from sheeprl_tpu_torch.distributions.distributions import (
    Bernoulli,
    Independent,
    MSEDistribution,
    Normal,
    OneHotCategorical,
    OneHotCategoricalStraightThrough,
    SymlogDistribution,
    TanhNormal,
    TruncatedNormal,
    TwoHotEncodingDistribution,
    gumbel_noise,
    kl_divergence,
    symexp,
    symlog,
    truncated_uniform_noise,
)

__all__ = [
    "Bernoulli",
    "Independent",
    "MSEDistribution",
    "Normal",
    "OneHotCategorical",
    "OneHotCategoricalStraightThrough",
    "SymlogDistribution",
    "TanhNormal",
    "TruncatedNormal",
    "TwoHotEncodingDistribution",
    "gumbel_noise",
    "kl_divergence",
    "symexp",
    "symlog",
    "truncated_uniform_noise",
]

"""Distributions the serving slice needs (counterpart of ``sheeprl_tpu/distributions``)."""

from sheeprl_tpu_torch.distributions.distributions import (
    OneHotCategorical,
    OneHotCategoricalStraightThrough,
    gumbel_noise,
)

__all__ = ["OneHotCategorical", "OneHotCategoricalStraightThrough", "gumbel_noise"]

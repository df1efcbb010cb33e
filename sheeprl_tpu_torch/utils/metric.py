"""Metric aggregation (counterpart of ``sheeprl_tpu/utils/metric.py``).

Host-side accumulators over Python floats: callers pass values they have
already pulled from the device (the training loop pulls a burst's metrics
at most once, behind ``train.burst.metric_fetch_gate``). One process, one
device, so ``sync_on_compute`` has nothing to reduce over: the identity.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

__all__ = ["MeanMetric", "Metric", "MetricAggregator", "SumMetric"]


def _to_scalar(value: Any) -> float:
    """Python numbers, numpy scalars and 0-dim tensors."""
    if hasattr(value, "item"):
        return float(value.item())
    return float(value)


class Metric:
    """Base accumulator. Subclasses define how values fold together."""

    def __init__(self, sync_on_compute: bool = False):
        self.sync_on_compute = sync_on_compute
        self.reset()

    def update(self, value: Any, weight: float = 1.0) -> None:
        raise NotImplementedError

    def compute(self) -> float:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError


class MeanMetric(Metric):
    def reset(self) -> None:
        self._sum = 0.0
        self._count = 0.0

    def update(self, value: Any, weight: float = 1.0) -> None:
        self._sum += _to_scalar(value) * weight
        self._count += weight

    def compute(self) -> float:
        return self._sum / self._count if self._count else float("nan")


class SumMetric(Metric):
    def reset(self) -> None:
        self._sum = 0.0

    def update(self, value: Any, weight: float = 1.0) -> None:
        self._sum += _to_scalar(value)

    def compute(self) -> float:
        return self._sum


class MetricAggregator:
    """Name→Metric dict driven by config. ``update`` on a missing key raises
    only when ``raise_on_missing``; ``compute`` drops NaN values."""

    disabled: bool = False

    def __init__(self, metrics: Optional[Dict[str, Metric]] = None, raise_on_missing: bool = False):
        self.metrics: Dict[str, Metric] = dict(metrics or {})
        self._raise_on_missing = raise_on_missing

    def update(self, name: str, value: Any, weight: float = 1.0) -> None:
        if self.disabled:
            return
        metric = self.metrics.get(name)
        if metric is None:
            if self._raise_on_missing:
                raise KeyError(f"Metric '{name}' not present in the aggregator")
            return
        metric.update(value, weight)

    def reset(self) -> None:
        for metric in self.metrics.values():
            metric.reset()

    def compute(self) -> Dict[str, float]:
        if self.disabled:
            return {}
        out: Dict[str, float] = {}
        for name, metric in self.metrics.items():
            value = metric.compute()
            if not (isinstance(value, float) and math.isnan(value)):
                out[name] = value
        return out

    def __contains__(self, name: str) -> bool:
        return name in self.metrics

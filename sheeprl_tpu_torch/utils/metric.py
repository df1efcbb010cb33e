"""Metric aggregation (counterpart of ``sheeprl_tpu/utils/metric.py``).

Host-side accumulators over Python floats: callers pass values they have
already pulled from the device (the training loop pulls a burst's metrics
at most once, behind ``train.burst.metric_fetch_gate``).

In a data-parallel world each rank steps its own envs, and the JAX
package's one process saw every env's episodes: at a log boundary
:meth:`MetricAggregator.sync` sums every metric's state over the ranks (one
all-reduce), so rank 0 logs the mean over every rank's updates. The train
metrics are already the world's mean inside the step (equal on every
rank), so their mean is unchanged. ``sync_on_compute`` is read by nothing.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

__all__ = ["MeanMetric", "Metric", "MetricAggregator", "SumMetric", "set_value_guard"]

# Run-health hook (obs/health.py NonFiniteGuard): when set, every value
# entering an aggregator is offered to the guard after its one conversion to
# a Python float, the one chokepoint all loops log their losses through.
_VALUE_GUARD = None


def set_value_guard(guard) -> None:
    """Install (or with ``None`` remove) the metric value guard."""
    global _VALUE_GUARD
    _VALUE_GUARD = guard


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
        if _VALUE_GUARD is not None:
            value = _to_scalar(value)
            _VALUE_GUARD(name, value)
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

    def sync(self, fabric) -> None:
        """Sum every metric's state (a mean's sum and count, a sum) over the
        ranks of ``fabric``'s world, in one all-reduce; every rank calls it
        at the same log boundary. A no-op outside a world."""
        if self.disabled or not getattr(fabric, "is_distributed", False):
            return
        import numpy as np

        names = sorted(self.metrics)
        state = []
        for name in names:
            m = self.metrics[name]
            state += [m._sum, m._count] if isinstance(m, MeanMetric) else [m._sum, 0.0]
        total = fabric.all_reduce(np.asarray(state, np.float64)).tolist()
        for i, name in enumerate(names):
            m = self.metrics[name]
            m._sum = total[2 * i]
            if isinstance(m, MeanMetric):
                m._count = total[2 * i + 1]

    def __contains__(self, name: str) -> bool:
        return name in self.metrics

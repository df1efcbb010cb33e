"""Log-bucket streaming histogram for latencies (the port's copy of
``StreamingHist`` in ``sheeprl_tpu/obs/hist.py``: record, quantile,
percentiles).

Buckets are ``floor(log2(v) * 8)``, about 9% relative width each, so the
p50/p95/p99 of a run cost a few hundred bytes and no sample array.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Dict, Optional

__all__ = ["StreamingHist"]

BUCKETS_PER_OCTAVE = 8


def _bounds(index: int) -> tuple:
    return (2.0 ** (index / BUCKETS_PER_OCTAVE), 2.0 ** ((index + 1) / BUCKETS_PER_OCTAVE))


def _ms(seconds: Optional[float]) -> Optional[float]:
    return None if seconds is None else round(seconds * 1e3, 3)


class StreamingHist:
    """Thread-safe sparse histogram over log-spaced buckets. Values ``<= 0``
    count in a zero bucket below every positive one."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counts: Dict[int, int] = {}
        self.zero = 0
        self.n = 0
        self.sum = 0.0
        self.max = 0.0

    def record(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self.n += 1
            if value <= 0.0:
                self.zero += 1
                return
            idx = math.floor(math.log2(value) * BUCKETS_PER_OCTAVE)
            self.counts[idx] = self.counts.get(idx, 0) + 1
            self.sum += value
            self.max = max(self.max, value)

    def quantile(self, q: float) -> Optional[float]:
        """The ``q``-quantile as the geometric middle of its bucket."""
        with self._lock:
            return self._quantile_locked(q)

    def _quantile_locked(self, q: float) -> Optional[float]:
        if self.n == 0:
            return None
        rank = q * self.n
        if rank <= self.zero:
            return 0.0
        seen = self.zero
        for idx in sorted(self.counts):
            seen += self.counts[idx]
            if seen >= rank:
                lo, hi = _bounds(idx)
                return math.sqrt(lo * hi)
        lo, hi = _bounds(max(self.counts))
        return math.sqrt(lo * hi)

    def percentiles(self) -> Dict[str, Any]:
        """``p50/p95/p99`` (bucketed) and exact ``count``/``mean_ms``/``max_ms``."""
        with self._lock:
            n_pos = self.n - self.zero
            return {
                "count": self.n,
                "p50_ms": _ms(self._quantile_locked(0.50)),
                "p95_ms": _ms(self._quantile_locked(0.95)),
                "p99_ms": _ms(self._quantile_locked(0.99)),
                "mean_ms": _ms(self.sum / n_pos) if n_pos else 0.0,
                "max_ms": _ms(self.max),
            }

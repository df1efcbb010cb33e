"""Mergeable log-bucket streaming histograms for span durations (the port's
copy of ``sheeprl_tpu/obs/hist.py``; a dump from either package loads into
the other's).

Whole-run *averages* (``sps``, ``env_seconds`` / ``train_seconds``) hide
exactly what a production operator needs to
see: tail latency. A recompile storm that doubles one train step in twenty,
an env worker that hiccups every few hundred interactions, a staging burst
that occasionally waits out a full prefetch miss — all of them vanish into a
mean. :class:`StreamingHist` records every span duration into logarithmic
buckets (constant *relative* resolution, ~9% per bucket), so ``p50/p95/p99``
per phase costs a few hundred bytes of memory and one ``log2`` per
observation, never a sample array.

Bucketing is a pure function of the value (``floor(log2(v) × 8)``), which
makes histograms **exactly mergeable**: the same observations recorded on
any split of threads/ranks/processes produce bit-identical bucket maps, and
:meth:`StreamingHist.merge` is plain per-bucket addition. Decoupled
player↔trainer runs merge their per-role tails losslessly — the per-role
p99 is precisely what the stall watchdog's binary alive/wedged view cannot
show.

Like the counter module, everything is a no-op until ``setup_telemetry``
calls :func:`install`: with no set installed, :func:`observe` is one global
read and a ``None`` check, so instrumented span exits cost nothing in
un-instrumented runs (no histogram exists when telemetry is off).
"""

from __future__ import annotations

import math
import threading
from typing import Any, Callable, Dict, Iterable, Optional

__all__ = [
    "HistogramSet",
    "StreamingHist",
    "install",
    "installed",
    "observe",
]

#: buckets per power of two — 8 gives ~9% relative resolution per bucket
#: (2**(1/8) ≈ 1.0905), plenty for latency percentiles at ~100 B/decade
BUCKETS_PER_OCTAVE = 8
_LOG_SCALE = float(BUCKETS_PER_OCTAVE)

_HISTS: Optional["HistogramSet"] = None


def install(hists: Optional["HistogramSet"]) -> None:
    """Activate (or with ``None`` deactivate) the run's histogram set."""
    global _HISTS
    _HISTS = hists


def installed() -> Optional["HistogramSet"]:
    return _HISTS


def observe(name: str, seconds: float) -> None:
    """Record one span duration (no-op when telemetry/histograms are off)."""
    h = _HISTS
    if h is not None:
        h.observe(name, seconds)


def bucket_index(value: float) -> int:
    """Deterministic log bucket of a positive value."""
    return math.floor(math.log2(value) * _LOG_SCALE)


def bucket_bounds(index: int) -> tuple:
    """``[lo, hi)`` value bounds of a bucket index."""
    return (2.0 ** (index / _LOG_SCALE), 2.0 ** ((index + 1) / _LOG_SCALE))


class StreamingHist:
    """A streaming histogram over log-spaced buckets.

    Sparse (``{bucket_index: count}``), thread-safe, and exactly mergeable:
    bucket indices depend only on the observed values, so any partition of
    the same observations merges back to the identical histogram. Values
    ``<= 0`` (a clock that did not advance) land in a dedicated zero bucket
    and count toward ``n`` but sit below every positive bucket for
    quantiles.
    """

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
            idx = bucket_index(value)
            self.counts[idx] = self.counts.get(idx, 0) + 1
            self.sum += value
            if value > self.max:
                self.max = value

    def record_many(self, values) -> None:
        """Record a whole array of observations vectorized (one ``np.log2``
        over the batch instead of a Python call per element — the
        staleness tracker observes every sampled row's age this way).
        Bucketing is bit-identical to :meth:`record`: both compute
        ``floor(log2(v) × 8)`` in float64."""
        import numpy as np

        vals = np.asarray(values, dtype=np.float64).reshape(-1)
        if vals.size == 0:
            return
        pos = vals[vals > 0.0]
        n_zero = int(vals.size - pos.size)
        if pos.size:
            idxs = np.floor(np.log2(pos) * _LOG_SCALE).astype(np.int64)
            uniq, counts = np.unique(idxs, return_counts=True)
            total, mx = float(pos.sum()), float(pos.max())
        else:
            uniq = counts = ()
            total, mx = 0.0, 0.0
        with self._lock:
            self.n += int(vals.size)
            self.zero += n_zero
            for idx, c in zip(uniq, counts):
                self.counts[int(idx)] = self.counts.get(int(idx), 0) + int(c)
            self.sum += total
            if mx > self.max:
                self.max = mx

    def quantile(self, q: float) -> Optional[float]:
        """The ``q``-quantile (0..1) as the geometric mid of its bucket."""
        with self._lock:
            return self._quantile_locked(q)

    def _quantile_locked(self, q: float) -> Optional[float]:
        if self.n == 0:
            return None
        # rank among all observations; the zero bucket sorts first
        rank = q * self.n
        if rank <= self.zero:
            return 0.0
        seen = self.zero
        for idx in sorted(self.counts):
            seen += self.counts[idx]
            if seen >= rank:
                lo, hi = bucket_bounds(idx)
                return math.sqrt(lo * hi)
        lo, hi = bucket_bounds(max(self.counts)) if self.counts else (0.0, 0.0)
        return math.sqrt(lo * hi) if self.counts else 0.0

    def percentiles(self) -> Dict[str, Any]:
        """The reporting dict: ``p50/p95/p99`` in milliseconds plus exact
        ``count`` / ``mean_ms`` / ``max_ms`` (the extremes are tracked
        exactly, not bucketed)."""
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

    # -- merge / serialization ----------------------------------------------

    def merge(self, other: "StreamingHist") -> "StreamingHist":
        with other._lock:
            counts = dict(other.counts)
            zero, n, total, mx = other.zero, other.n, other.sum, other.max
        with self._lock:
            for idx, c in counts.items():
                self.counts[idx] = self.counts.get(idx, 0) + c
            self.zero += zero
            self.n += n
            self.sum += total
            if mx > self.max:
                self.max = mx
        return self

    def to_dict(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "buckets": {str(k): v for k, v in sorted(self.counts.items())},
                "zero": self.zero,
                "n": self.n,
                "sum": self.sum,
                "max": self.max,
                "buckets_per_octave": BUCKETS_PER_OCTAVE,
            }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "StreamingHist":
        if int(d.get("buckets_per_octave", BUCKETS_PER_OCTAVE)) != BUCKETS_PER_OCTAVE:
            raise ValueError(
                "histogram dump uses a different bucket base "
                f"({d.get('buckets_per_octave')} buckets/octave, this build "
                f"uses {BUCKETS_PER_OCTAVE}) — buckets are not mergeable"
            )
        h = cls()
        h.counts = {int(k): int(v) for k, v in (d.get("buckets") or {}).items()}
        h.zero = int(d.get("zero", 0))
        h.n = int(d.get("n", 0))
        h.sum = float(d.get("sum", 0.0))
        h.max = float(d.get("max", 0.0))
        return h


def _ms(seconds: Optional[float]) -> Optional[float]:
    return None if seconds is None else round(seconds * 1e3, 3)


class HistogramSet:
    """Per-phase histograms keyed by span name, plus the slow-span trigger.

    ``on_slow(name, seconds, p50_seconds)`` fires when an observation
    exceeds ``slow_factor × running p50`` after ``slow_warmup`` observations
    of that phase — the flight-recorder hook. ``slow_min_s`` is an absolute
    floor: sub-millisecond phases jitter 10x on GC pauses alone, and a
    "3 ms anomaly" is never actionable, so only observations above the floor
    can trigger. The p50 is cached and refreshed every few records, so the
    hot-path cost of an observation stays one dict lookup + one ``log2``.
    """

    #: records between running-p50 refreshes (per phase)
    _P50_REFRESH = 32

    def __init__(
        self,
        slow_factor: float = 0.0,
        slow_warmup: int = 64,
        slow_min_s: float = 0.0,
        on_slow: Optional[Callable[[str, float, float], None]] = None,
    ):
        self.slow_factor = float(slow_factor)
        self.slow_warmup = int(slow_warmup)
        self.slow_min_s = float(slow_min_s)
        self.on_slow = on_slow
        self._lock = threading.Lock()
        self._hists: Dict[str, StreamingHist] = {}
        self._p50_cache: Dict[str, tuple] = {}  # name -> (p50, refresh_at_n)

    def get(self, name: str) -> StreamingHist:
        h = self._hists.get(name)
        if h is None:
            with self._lock:
                h = self._hists.setdefault(name, StreamingHist())
        return h

    def observe(self, name: str, seconds: float) -> None:
        h = self.get(name)
        h.record(seconds)
        if self.on_slow is None or self.slow_factor <= 0 or seconds < self.slow_min_s:
            return
        n = h.n
        if n <= self.slow_warmup:
            # the p50 is only trustworthy once `slow_warmup` observations
            # precede the candidate — cold-start outliers are expected
            return
        p50, refresh_at = self._p50_cache.get(name, (None, 0))
        if p50 is None or n >= refresh_at:
            p50 = h.quantile(0.50)
            self._p50_cache[name] = (p50, n + self._P50_REFRESH)
        if p50 and seconds > self.slow_factor * p50:
            # refresh the cached p50 eagerly so a genuine regime shift (a
            # phase that legitimately got slower) re-arms at the new median
            # instead of re-firing forever
            self._p50_cache[name] = (h.quantile(0.50), n + self._P50_REFRESH)
            try:
                self.on_slow(name, seconds, p50)
            except Exception:
                # the hook runs inside span.__exit__ on the train path: a
                # telemetry bug must never take the run down
                pass

    def percentiles(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            names = sorted(self._hists)
        return {name: self._hists[name].percentiles() for name in names}

    # -- merge / serialization ----------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        with self._lock:
            names = sorted(self._hists)
        return {name: self._hists[name].to_dict() for name in names}

    def merge_dict(self, dumped: Dict[str, Any]) -> None:
        """Merge a :meth:`to_dict` dump (another rank/role) into this set."""
        for name, d in (dumped or {}).items():
            self.get(name).merge(StreamingHist.from_dict(d))

    @classmethod
    def merge_all(cls, dumps: Iterable[Dict[str, Any]]) -> "HistogramSet":
        out = cls()
        for d in dumps:
            out.merge_dict(d)
        return out

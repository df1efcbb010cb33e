"""Data-staleness lineage: sample age, policy lag, and queue-depth gauges
(counterpart of ``sheeprl_tpu/obs/dist/staleness.py``).

Every actor–learner stack lives or dies by two distributions nobody was
measuring here: **how old is the data a gradient step consumes** (wall
seconds between a transition landing in replay and being drawn into a
batch) and **how stale is the policy that collected it** (published
versions behind the learner at collection time). This module owns both:

- trajectory rows are stamped when they enter the replay buffer
  (``ReplayBuffer.add`` — for plane runs the slab's *commit* timestamp is
  carried across the process boundary and consumed via
  :meth:`StalenessTracker.stamp_next_add`, so the age clock starts at
  collection, not at the learner-side copy);
- every host sampling plan (``ReplayBuffer.plan_transitions``,
  ``SequentialReplayBuffer``'s sequence starts and the replay strategies'
  plans, all through ``ReplayBuffer.observe_sample_ages``) observes the
  ages of the rows it drew into the ``sample_age_s`` histogram, vectorized
  so a 10k-row burst plan costs one ``np.log2``, not 10k Python calls (the
  device ring of ``env.backend=jax`` draws on the device and is not
  observed);
- the plane supervisor observes ``policy_lag_versions`` (last published
  version − the version that collected each received burst) per slab, and
  the slab/prefetch queues report depth gauges (last + max) so
  backpressure is a number.

Percentiles surface as the ``staleness`` section of ``telemetry.json`` /
``live.json`` (plus flat ``sample_age_p95_s`` for ``tools/bench_compare.py``)
and as ``sheeprl_sample_age_seconds{quantile=...}`` Prometheus series.
Installed by ``setup_telemetry``; with no tracker installed every hook is a
single global read.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

import numpy as np

from sheeprl_tpu_torch.obs.hist import StreamingHist

__all__ = [
    "StalenessTracker",
    "install",
    "installed",
    "observe_policy_lag",
    "observe_sample_ages",
    "stamp_next_add",
    "note_queue_depth",
    "take_add_stamp",
]

_TRACKER: Optional["StalenessTracker"] = None


def install(tracker: Optional["StalenessTracker"]) -> None:
    """Activate (or with ``None`` deactivate) the run's staleness tracker."""
    global _TRACKER
    _TRACKER = tracker


def installed() -> Optional["StalenessTracker"]:
    return _TRACKER


class StalenessTracker:
    """Run-wide staleness state (thread-safe; shared by the learner loop,
    the prefetch worker, and the plane supervisor)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.sample_age = StreamingHist()
        self.policy_lag = StreamingHist()
        self._queues: Dict[str, Dict[str, float]] = {}
        self._pending_stamp: Optional[float] = None

    # -- add-time stamping ---------------------------------------------------

    def stamp_next_add(self, ts: float) -> None:
        """Override the timestamp of the next ``ReplayBuffer.add`` — the
        plane learner sets the slab's commit time here right before copying
        the slab rows in, so sample age is measured from collection."""
        with self._lock:
            self._pending_stamp = float(ts)

    def take_add_stamp(self) -> float:
        """The stamp for rows being added right now (one-shot override, else
        the current wall clock)."""
        with self._lock:
            ts, self._pending_stamp = self._pending_stamp, None
        return time.time() if ts is None else ts

    # -- observations --------------------------------------------------------

    def observe_sample_ages(self, ages_s: np.ndarray) -> None:
        """Record the ages (seconds) of one sampling plan's drawn rows."""
        self.sample_age.record_many(ages_s)

    def observe_policy_lag(self, lag_versions: int, n: int = 1) -> None:
        """Record the version lag of one received trajectory burst."""
        lag = max(int(lag_versions), 0)
        for _ in range(max(int(n), 1)):
            self.policy_lag.record(float(lag))

    def note_queue_depth(self, name: str, depth: Optional[int]) -> None:
        """Update a queue-depth gauge (``last`` + running ``max``)."""
        if depth is None:
            return
        depth = int(depth)
        with self._lock:
            g = self._queues.setdefault(name, {"last": 0, "max": 0, "samples": 0})
            g["last"] = depth
            g["max"] = max(g["max"], depth)
            g["samples"] += 1

    # -- reporting -----------------------------------------------------------

    @staticmethod
    def _pcts(hist: StreamingHist, unit: str, digits: int = 4) -> Dict[str, Any]:
        def q(p):
            v = hist.quantile(p)
            return None if v is None else round(v, digits)

        return {
            "count": hist.n,
            f"p50_{unit}": q(0.50),
            f"p95_{unit}": q(0.95),
            f"p99_{unit}": q(0.99),
            f"max_{unit}": round(hist.max, digits),
        }

    def summary(self) -> Optional[Dict[str, Any]]:
        """The ``staleness`` section of the run summary, or None when
        nothing was ever observed (coupled single-process runs that never
        sampled replay stay clean)."""
        if self.sample_age.n == 0 and self.policy_lag.n == 0 and not self._queues:
            return None
        out: Dict[str, Any] = {}
        if self.sample_age.n:
            out["sample_age_s"] = self._pcts(self.sample_age, "s")
        if self.policy_lag.n:
            # lags are small integers; 2 digits keeps the geometric-mid
            # bucket estimates readable
            out["policy_lag_versions"] = self._pcts(self.policy_lag, "v", digits=2)
        if self._queues:
            with self._lock:
                out["queue_depth"] = {k: dict(v) for k, v in self._queues.items()}
        return out

    # -- sidecar serialization ----------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        with self._lock:
            queues = {k: dict(v) for k, v in self._queues.items()}
        return {
            "sample_age": self.sample_age.to_dict(),
            "policy_lag": self.policy_lag.to_dict(),
            "queues": queues,
        }

    def merge_dict(self, dumped: Dict[str, Any]) -> None:
        """Merge another process's tracker dump (exact — same log-bucket
        merge as the phase histograms)."""
        if not isinstance(dumped, dict):
            return
        if dumped.get("sample_age"):
            self.sample_age.merge(StreamingHist.from_dict(dumped["sample_age"]))
        if dumped.get("policy_lag"):
            self.policy_lag.merge(StreamingHist.from_dict(dumped["policy_lag"]))
        for name, g in (dumped.get("queues") or {}).items():
            with self._lock:
                mine = self._queues.setdefault(name, {"last": 0, "max": 0, "samples": 0})
                mine["max"] = max(mine["max"], int(g.get("max", 0)))
                mine["samples"] += int(g.get("samples", 0))
                # "last" keeps the local value — a remote last is not newer


# -- module-level hooks (no-ops when telemetry is off) ------------------------


def observe_sample_ages(ages_s: np.ndarray) -> None:
    t = _TRACKER
    if t is not None:
        t.observe_sample_ages(ages_s)


def observe_policy_lag(lag_versions: int, n: int = 1) -> None:
    t = _TRACKER
    if t is not None:
        t.observe_policy_lag(lag_versions, n)


def stamp_next_add(ts: float) -> None:
    t = _TRACKER
    if t is not None:
        t.stamp_next_add(ts)


def take_add_stamp() -> Optional[float]:
    """The add-time stamp, or None when no tracker is installed (callers
    then skip the stamping array entirely)."""
    t = _TRACKER
    return t.take_add_stamp() if t is not None else None


def note_queue_depth(name: str, depth: Optional[int]) -> None:
    t = _TRACKER
    if t is not None:
        t.note_queue_depth(name, depth)

"""Divergence early-warning over the learn probes (counterpart of
``sheeprl_tpu/obs/learn/sentinel.py``, host code ported as it is).

The sentinel is the host half of the learning-health plane: it receives each
burst's stacked probe samples (``obs.learn.observe_probes``), keeps a
streaming-histogram baseline (obs/hist.py) plus a running mean/std per probe
in log10 space (training dynamics are multiplicative — a 10x grad-norm jump
is the unit of interest, not +10), and fires graded events:

- ``warn`` — a grad-norm sample's z-score exceeds ``warn_z``, or the
  update-to-weight ratio collapses below ``-warn_z`` (a dead optimizer looks
  *quieter*, not louder);
- ``critical`` — ``critical_streak`` consecutive grad-norm samples above
  ``critical_z`` (sustained explosion: fires BEFORE the first NaN reaches
  the loss), or any non-finite gradient leaf / non-finite logged metric
  (the NonFiniteGuard's terminal stage — ``Telemetry._on_nonfinite`` routes
  into :meth:`LearnSentinel.on_nonfinite`).

Every event triggers the flight recorder (``learn_divergence`` reason, rate
limits apply), bumps the ``learn_warnings``/``learn_criticals`` counters, and
lands timestamped in the summary's ``learn.events`` — the acceptance
ordering (critical BEFORE first non-finite) is checked against
``learn.first_nonfinite_ts``.

Anomalous samples (|z| > critical_z) are NOT absorbed into the baseline:
a baseline that chases the explosion would re-arm mid-divergence and the
"sustained" criterion would never accumulate.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Dict, List, Mapping, Optional

from sheeprl_tpu_torch.obs.hist import StreamingHist

__all__ = ["LearnSentinel"]

#: floor for log10 of a probe sample (an exactly-zero grad norm)
_LOG_FLOOR = -30.0
#: events kept for the summary (counters stay exact beyond this)
_MAX_EVENTS = 64


def _log10(value: float) -> float:
    return math.log10(value) if value > 0.0 else _LOG_FLOOR


class _Baseline:
    """Welford mean/var in log10 space plus the mergeable value histogram."""

    __slots__ = ("hist", "n", "mean", "m2", "last")

    def __init__(self):
        self.hist = StreamingHist()
        self.n = 0
        self.mean = 0.0
        self.m2 = 0.0
        self.last = 0.0

    def z(self, log_value: float) -> Optional[float]:
        if self.n < 2:
            return None
        var = self.m2 / (self.n - 1)
        std = math.sqrt(var) if var > 0 else 0.0
        # std floor of 0.05 decades (~12% relative): an ultra-flat baseline
        # would otherwise turn benign drift into huge z-scores — below it a
        # "4-sigma" excursion can be a rounding-level wiggle, never actionable
        std = max(std, 0.05)
        return (log_value - self.mean) / std

    def absorb(self, value: float, log_value: float) -> None:
        self.hist.record(value)
        self.n += 1
        delta = log_value - self.mean
        self.mean += delta / self.n
        self.m2 += delta * (log_value - self.mean)
        self.last = value


class LearnSentinel:
    """Graded divergence events over streaming probe baselines.

    ``cfg`` is the ``metric.telemetry.learn`` dict; ``counters`` the run's
    ``obs.counters.Counters``; ``flight`` the FlightRecorder (or None);
    ``step_source`` an optional zero-arg callable giving the current policy
    step for events observed without an explicit step.
    """

    def __init__(
        self,
        cfg: Optional[Mapping[str, Any]] = None,
        counters: Any = None,
        flight: Any = None,
        step_source: Any = None,
    ):
        cfg = dict(cfg or {})
        self.every_n_bursts = max(int(cfg.get("every_n_bursts", 1) or 1), 1)
        self.warn_z = float(cfg.get("warn_z", 4.0))
        self.critical_z = float(cfg.get("critical_z", 8.0))
        self.warmup = max(int(cfg.get("warmup", 20)), 2)
        self.critical_streak = max(int(cfg.get("critical_streak", 3)), 1)
        self._counters = counters
        self._flight = flight
        self._step_source = step_source
        self._lock = threading.Lock()
        self._baselines: Dict[str, _Baseline] = {}
        self._streaks: Dict[str, int] = {}
        self._bursts_seen = 0
        self.warnings = 0
        self.criticals = 0
        self.events: List[Dict[str, Any]] = []
        self.first_nonfinite_ts: Optional[float] = None

    # -- cadence ------------------------------------------------------------

    def due_burst(self) -> bool:
        """Advance the burst counter; True when this burst's probes should be
        pulled (``every_n_bursts`` cadence, first burst always due)."""
        with self._lock:
            self._bursts_seen += 1
            return (self._bursts_seen - 1) % self.every_n_bursts == 0

    # -- observation --------------------------------------------------------

    def observe(self, probes: Mapping[str, Any], step: Optional[int] = None) -> None:
        """Record one burst's probes — each value a scalar or a stacked
        ``[n]`` array of per-gradient-step samples (host numpy)."""
        import numpy as np

        if step is None and self._step_source is not None:
            try:
                step = int(self._step_source())
            except Exception:
                step = None
        with self._lock:
            for key in sorted(probes):
                vals = np.ravel(np.asarray(probes[key], dtype=np.float64))
                for v in vals:
                    self._observe_one(key, float(v), step)

    def _observe_one(self, key: str, value: float, step: Optional[int]) -> None:
        if key.endswith("/nonfinite") or key == "learn/nonfinite":
            if value > 0:
                self._fire(
                    "critical", key, value, None, step, reason="nonfinite_grads"
                )
                self._note_nonfinite()
            return
        if not math.isfinite(value):
            self._fire("critical", key, value, None, step, reason="nonfinite_probe")
            self._note_nonfinite()
            return
        base = self._baselines.get(key)
        if base is None:
            base = self._baselines[key] = _Baseline()
        lv = _log10(value)
        z = base.z(lv) if base.n >= self.warmup else None
        is_grad = key.startswith("learn/grad_norm")
        is_ratio = key == "learn/update_ratio"
        anomalous = False
        if z is not None:
            if is_grad and z > self.critical_z:
                anomalous = True
                streak = self._streaks.get(key, 0) + 1
                self._streaks[key] = streak
                if streak >= self.critical_streak:
                    self._fire(
                        "critical", key, value, z, step, reason="sustained_explosion"
                    )
                    self._streaks[key] = 0
                else:
                    self._fire("warn", key, value, z, step, reason="grad_norm_excursion")
            elif is_grad and z > self.warn_z:
                self._streaks[key] = 0
                self._fire("warn", key, value, z, step, reason="grad_norm_excursion")
            elif is_ratio and z < -self.warn_z:
                self._fire("warn", key, value, z, step, reason="update_ratio_collapse")
            elif is_grad:
                self._streaks[key] = 0
        if not anomalous:
            base.absorb(value, lv)

    def on_nonfinite(self, name: str, value: Any) -> None:
        """NonFiniteGuard terminal stage: a non-finite value reached the
        metric aggregator. Timestamps the first occurrence (the acceptance
        ordering reference) and records a critical event."""
        with self._lock:
            self._note_nonfinite()
            self._fire(
                "critical",
                f"metric:{name}",
                float("nan"),
                None,
                None,
                reason="nonfinite_metric",
            )

    def _note_nonfinite(self) -> None:
        if self.first_nonfinite_ts is None:
            self.first_nonfinite_ts = time.time()

    # -- events -------------------------------------------------------------

    def _fire(
        self,
        severity: str,
        probe: str,
        value: float,
        z: Optional[float],
        step: Optional[int],
        reason: str,
    ) -> None:
        event = {
            "severity": severity,
            "probe": probe,
            "reason": reason,
            "value": None if not math.isfinite(value) else round(value, 6),
            "z": round(z, 3) if z is not None else None,
            "step": step,
            "ts_unix": time.time(),
        }
        if severity == "critical":
            self.criticals += 1
        else:
            self.warnings += 1
        if len(self.events) < _MAX_EVENTS:
            self.events.append(event)
        if self._counters is not None:
            try:
                self._counters.add_learn_event(
                    warnings=1 if severity == "warn" else 0,
                    criticals=1 if severity == "critical" else 0,
                )
            except Exception:
                pass
        if self._flight is not None:
            try:
                self._flight.trigger("learn_divergence", dict(event))
            except Exception:
                # telemetry must never take the run down
                pass

    # -- reporting ----------------------------------------------------------

    def quantile(self, key: str, q: float) -> Optional[float]:
        with self._lock:
            base = self._baselines.get(key)
            return base.hist.quantile(q) if base is not None else None

    def summary(self) -> Dict[str, Any]:
        """The ``learn`` sub-dict of telemetry.json / live.json."""
        with self._lock:
            probes: Dict[str, Any] = {}
            for key in sorted(self._baselines):
                base = self._baselines[key]
                probes[key] = {
                    "n": base.n,
                    "last": round(base.last, 6),
                    "p50": base.hist.quantile(0.50),
                    "p95": base.hist.quantile(0.95),
                    "max": base.hist.max,
                }
            return {
                "warnings": self.warnings,
                "criticals": self.criticals,
                "bursts_observed": self._bursts_seen,
                "first_nonfinite_ts": self.first_nonfinite_ts,
                "events": list(self.events),
                "probes": probes,
            }

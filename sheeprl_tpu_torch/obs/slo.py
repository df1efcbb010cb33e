"""Declarative SLO engine: rolling windows and multi-window burn-rate
alerts (counterpart of ``sheeprl_tpu/obs/slo.py``: the same objectives,
buckets, thresholds, records and verdicts).

Objectives come from ``configs/serve/default.yaml`` (``serve.slo.*``). Each
is a stream of good and bad events against an error budget, the multiwindow
burn-rate method of the SRE Workbook (Beyer et al., 2018):

- ``act_latency_p99_ms``: 99% of requests answer within X ms; a slower
  request is a bad event, the budget is 1%.
- ``availability``: ``1 - failed/total``; a failed request is a bad event,
  the budget is ``1 - target``. Tickets the client cancelled are left out
  of the denominator: the server never answered them.
- ``swap_staleness_s``: a published policy version must be serving within
  X seconds. Sampled as a gauge each evaluation tick against a near-zero
  budget, so one violation burns hot at once (a hard bound).

``burn_rate = (bad / (good + bad) over the window) / budget``: burn 1.0
spends the budget exactly at the sustainable rate. Each objective has a
fast alert (short window, high threshold: cliffs in seconds) and a slow one
(long window, low threshold: slow leaks). An alert fires above its
threshold and clears only below ``clear_ratio x threshold`` (hysteresis).
Every transition is one line of ``alerts.jsonl`` and calls ``on_alert``
(the gateway trips its flight recorder with ``reason=slo_burn``).

The engine imports nothing of serving and takes an injected clock, so tests
drive hand-computed windows without sleeping; the live wiring (the tick
thread, the staleness probe, the request feed) is
:mod:`sheeprl_tpu_torch.serve.ops`.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["Objective", "SloEngine", "slo_settings"]

#: the engine's defaults, which configs/serve/default.yaml repeats (and overrides)
_DEFAULTS: Dict[str, Any] = {
    "enabled": False,
    "window_s": 60.0,        # slow burn-rate window
    "fast_window_s": 5.0,    # fast burn-rate window
    "slow_burn": 6.0,        # slow-alert threshold (x budget rate)
    "fast_burn": 14.4,       # fast-alert threshold (x budget rate)
    "clear_ratio": 0.5,      # hysteresis: clear below clear_ratio x threshold
    "eval_interval_s": 1.0,  # evaluation-tick cadence (the serve/ops.py thread)
    "objectives": {
        "act_latency_p99_ms": 250.0,
        "availability": 0.999,
        "swap_staleness_s": 30.0,
    },
}


def slo_settings(cfg: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """The ``serve.slo`` block merged over the engine defaults."""
    out = {k: (dict(v) if isinstance(v, dict) else v) for k, v in _DEFAULTS.items()}
    for key, val in dict(cfg or {}).items():
        if key == "objectives" and isinstance(val, dict):
            out["objectives"].update({k: v for k, v in val.items() if v is not None})
        elif val is not None:
            out[key] = val
    return out


class _Buckets:
    """Good/bad event counts in 1-second time buckets over a bounded horizon."""

    def __init__(self, horizon_s: float, bucket_s: float = 1.0):
        self.bucket_s = float(bucket_s)
        self._maxlen = max(2, int(horizon_s / self.bucket_s) + 2)
        self._buckets: deque = deque(maxlen=self._maxlen)  # (bucket_idx, good, bad)
        self.total_good = 0
        self.total_bad = 0

    def add(self, t: float, good: int = 0, bad: int = 0) -> None:
        idx = int(t / self.bucket_s)
        if self._buckets and self._buckets[-1][0] == idx:
            _, g, b = self._buckets[-1]
            self._buckets[-1] = (idx, g + good, b + bad)
        else:
            self._buckets.append((idx, good, bad))
        self.total_good += good
        self.total_bad += bad

    def window(self, t: float, window_s: float) -> Tuple[int, int]:
        """(good, bad) counted over the trailing ``window_s`` ending at t."""
        lo = int((t - window_s) / self.bucket_s)
        hi = int(t / self.bucket_s)
        good = bad = 0
        for idx, g, b in self._buckets:
            if lo < idx <= hi:
                good += g
                bad += b
        return good, bad


class _BurnAlert:
    """One burn-rate alert with fire/clear hysteresis."""

    def __init__(self, name: str, window_s: float, threshold: float, clear_ratio: float):
        self.name = name
        self.window_s = float(window_s)
        self.threshold = float(threshold)
        self.clear_below = float(clear_ratio) * self.threshold
        self.active = False
        self.fired = 0

    def update(self, burn: float) -> Optional[str]:
        """"fire" / "clear" on a state transition, else None."""
        if not self.active and burn > self.threshold:
            self.active = True
            self.fired += 1
            return "fire"
        if self.active and burn < self.clear_below:
            self.active = False
            return "clear"
        return None


class Objective:
    """One SLO: an error budget plus its fast/slow burn-rate alert pair."""

    def __init__(self, name: str, target: float, budget: float, settings: Dict[str, Any]):
        self.name = name
        self.target = float(target)
        #: allowed bad-event fraction; floored so a zero-budget (hard-bound)
        #: objective burns ~infinitely hot on its first bad event instead of
        #: dividing by zero
        self.budget = max(float(budget), 1e-9)
        self.events = _Buckets(horizon_s=float(settings["window_s"]))
        self.fast = _BurnAlert(
            "fast_burn", settings["fast_window_s"], settings["fast_burn"], settings["clear_ratio"]
        )
        self.slow = _BurnAlert(
            "slow_burn", settings["window_s"], settings["slow_burn"], settings["clear_ratio"]
        )

    def burn(self, t: float, window_s: float) -> Tuple[float, int, int]:
        good, bad = self.events.window(t, window_s)
        total = good + bad
        if total == 0:
            return 0.0, 0, 0
        return (bad / total) / self.budget, good, bad

    def verdict(self) -> str:
        """Cumulative whole-run compliance: PASS iff the overall bad-event
        fraction stayed inside the budget."""
        total = self.events.total_good + self.events.total_bad
        if total == 0:
            return "PASS"
        return "PASS" if (self.events.total_bad / total) <= self.budget else "FAIL"


class SloEngine:
    """The declarative engine: feed events, call :meth:`evaluate` on a tick."""

    def __init__(
        self,
        cfg: Optional[Dict[str, Any]] = None,
        alerts_path: Optional[str] = None,
        on_alert: Optional[Callable[[Dict[str, Any]], Any]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.settings = slo_settings(cfg)
        self._clock = clock
        self._on_alert = on_alert
        self._lock = threading.Lock()
        self.alerts_path = alerts_path
        self._alerts_file = None
        if alerts_path:
            os.makedirs(os.path.dirname(os.path.abspath(alerts_path)) or ".", exist_ok=True)
            self._alerts_file = open(alerts_path, "a")
        obj = self.settings["objectives"]
        self.objectives: Dict[str, Objective] = {}
        lat_ms = obj.get("act_latency_p99_ms")
        if lat_ms is not None:
            self.latency_bound_s = float(lat_ms) / 1e3
            self.objectives["act_latency_p99"] = Objective(
                "act_latency_p99", float(lat_ms), 0.01, self.settings
            )
        else:
            self.latency_bound_s = None
        avail = obj.get("availability")
        if avail is not None:
            self.objectives["availability"] = Objective(
                "availability", float(avail), 1.0 - float(avail), self.settings
            )
        stale_s = obj.get("swap_staleness_s")
        if stale_s is not None:
            self.staleness_bound_s = float(stale_s)
            self.objectives["swap_staleness"] = Objective(
                "swap_staleness", float(stale_s), 0.0, self.settings
            )
        else:
            self.staleness_bound_s = None
        self.cancelled = 0
        self.alert_log: List[Dict[str, Any]] = []

    # -- event feeds --------------------------------------------------------

    def record_request(
        self,
        latency_s: Optional[float],
        failed: bool = False,
        cancelled: bool = False,
        t: Optional[float] = None,
    ) -> None:
        """One retired act() ticket. Cancelled tickets only bump a gauge —
        the server never answered, so availability ignores them entirely."""
        t = self._clock() if t is None else t
        with self._lock:
            if cancelled:
                self.cancelled += 1
                return
            avail = self.objectives.get("availability")
            if avail is not None:
                avail.events.add(t, good=0 if failed else 1, bad=1 if failed else 0)
            lat = self.objectives.get("act_latency_p99")
            if lat is not None and not failed and latency_s is not None:
                slow = latency_s > self.latency_bound_s
                lat.events.add(t, good=0 if slow else 1, bad=1 if slow else 0)

    def record_staleness(self, staleness_s: float, t: Optional[float] = None) -> None:
        """One sampled swap-staleness gauge reading (seconds a newer
        published policy has been waiting beyond the serving version)."""
        obj = self.objectives.get("swap_staleness")
        if obj is None:
            return
        t = self._clock() if t is None else t
        with self._lock:
            stale = staleness_s > self.staleness_bound_s
            obj.events.add(t, good=0 if stale else 1, bad=1 if stale else 0)

    # -- evaluation ---------------------------------------------------------

    def evaluate(self, t: Optional[float] = None) -> List[Dict[str, Any]]:
        """One evaluation tick: update every alert pair, log transitions.

        Returns the transition records ("fire"/"clear") produced this tick.
        """
        t = self._clock() if t is None else t
        transitions: List[Dict[str, Any]] = []
        with self._lock:
            for obj in self.objectives.values():
                for alert in (obj.fast, obj.slow):
                    burn, good, bad = obj.burn(t, alert.window_s)
                    event = alert.update(burn)
                    if event is None:
                        continue
                    transitions.append(
                        {
                            "ts_unix": round(time.time(), 3),
                            "objective": obj.name,
                            "alert": alert.name,
                            "event": event,
                            "burn_rate": round(burn, 3),
                            "threshold": alert.threshold,
                            "window_s": alert.window_s,
                            "budget": obj.budget,
                            "good": good,
                            "bad": bad,
                        }
                    )
            for rec in transitions:
                self.alert_log.append(rec)
                if self._alerts_file is not None and not self._alerts_file.closed:
                    self._alerts_file.write(json.dumps(rec) + "\n")
            if transitions and self._alerts_file is not None and not self._alerts_file.closed:
                self._alerts_file.flush()
        if self._on_alert is not None:
            for rec in transitions:
                if rec["event"] == "fire":
                    try:
                        self._on_alert(rec)
                    except Exception:
                        pass  # an alerting sink must never take serving down
        return transitions

    # -- reporting ----------------------------------------------------------

    def status(self, t: Optional[float] = None) -> Dict[str, Any]:
        """Per-objective burn rates, alert states, and cumulative verdicts."""
        t = self._clock() if t is None else t
        with self._lock:
            out: Dict[str, Any] = {
                "enabled": bool(self.settings.get("enabled")),
                "cancelled_tickets": self.cancelled,
                "alerts_fired": sum(
                    o.fast.fired + o.slow.fired for o in self.objectives.values()
                ),
                "objectives": {},
            }
            for obj in self.objectives.values():
                burn_fast, _, _ = obj.burn(t, obj.fast.window_s)
                burn_slow, _, _ = obj.burn(t, obj.slow.window_s)
                out["objectives"][obj.name] = {
                    "target": obj.target,
                    "budget": obj.budget,
                    "good": obj.events.total_good,
                    "bad": obj.events.total_bad,
                    "burn_fast": round(burn_fast, 3),
                    "burn_slow": round(burn_slow, 3),
                    "fast_active": obj.fast.active,
                    "slow_active": obj.slow.active,
                    "fired": obj.fast.fired + obj.slow.fired,
                    "verdict": obj.verdict(),
                }
            return out

    def verdicts(self) -> Dict[str, str]:
        with self._lock:
            return {name: obj.verdict() for name, obj in self.objectives.items()}

    def close(self) -> None:
        with self._lock:
            if self._alerts_file is not None and not self._alerts_file.closed:
                self._alerts_file.close()

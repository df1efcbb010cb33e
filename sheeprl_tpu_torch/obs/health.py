"""Run-health guards: non-finite losses and stalled player/trainer threads
(counterpart of ``sheeprl_tpu/obs/health.py``).

Two failure modes silently waste whole runs:

- a loss goes NaN/inf and training keeps burning accelerator-hours on
  garbage gradients;
- one side of a decoupled player↔trainer pair hangs (a wedged env worker, a
  dead remote device link) and the other side waits forever on the exchange
  queue with no output at all.

:class:`NonFiniteGuard` hooks the shared metric-aggregation path (every algo
logs its losses through :class:`~sheeprl_tpu_torch.utils.metric.MetricAggregator`),
so any logged ``Loss/``-family value is checked where the loop already pulled
it to the host at a log boundary: the guard adds no pull of its own. :class:`StallWatchdog` is a heartbeat
monitor: each thread beats once per loop iteration, a daemon thread flags
roles whose last beat is older than the timeout, warns (once per stall
episode — re-armed when the role recovers), counts the stall, and marks it
on the trace timeline.
"""

from __future__ import annotations

import math
import threading
import time
import warnings
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

__all__ = ["NonFiniteGuard", "StallWatchdog"]


class NonFiniteGuard:
    """Callable ``(metric_name, value)`` guard for the aggregator hook."""

    def __init__(
        self,
        prefixes: Sequence[str] = ("Loss/", "Grads/"),
        raise_on_nonfinite: bool = False,
        counters=None,
        on_fire: Optional[Callable[[str, float], None]] = None,
    ):
        self.prefixes: Tuple[str, ...] = tuple(prefixes)
        self.raise_on_nonfinite = bool(raise_on_nonfinite)
        self._counters = counters
        self.on_fire = on_fire
        self._warned: set = set()
        self.fired = 0

    def __call__(self, name: str, value) -> None:
        if not name.startswith(self.prefixes):
            return
        try:
            v = float(np.asarray(value))
        except Exception:
            return
        if math.isfinite(v):
            return
        self.fired += 1
        if self._counters is not None:
            self._counters.add("nonfinite_metrics", 1)
        from sheeprl_tpu_torch.obs.spans import get_tracer

        tracer = get_tracer()
        if tracer is not None:
            tracer.instant("nonfinite_metric", args={"metric": name, "value": str(v)})
        if self.on_fire is not None:
            try:
                self.on_fire(name, v)
            except Exception:
                pass
        if name not in self._warned:
            self._warned.add(name)
            warnings.warn(
                f"run-health: non-finite value {v} logged for '{name}' — the "
                "optimization has likely diverged (further occurrences of this "
                "metric are counted, not re-warned)",
                RuntimeWarning,
            )
        if self.raise_on_nonfinite:
            raise FloatingPointError(
                f"run-health: non-finite value {v} logged for '{name}' "
                "(metric.telemetry.health.raise_on_nonfinite=true)"
            )


class StallWatchdog:
    """Heartbeat watchdog for decoupled player↔trainer threads.

    Usage::

        watchdog = StallWatchdog(timeout_s=120.0)
        watchdog.register("player")
        watchdog.start()
        ...          # player thread: watchdog.beat("player") once per loop
        watchdog.stop()

    A role whose last beat is older than ``timeout_s`` is flagged exactly
    once per stall episode; a subsequent beat re-arms it. ``on_stall(role,
    age_s)`` runs on the watchdog thread (keep it cheap).

    Cold-start grace: until a role has beaten twice (= completed one full
    iteration), its threshold is ``timeout_s × warmup_factor`` — the first
    iteration legitimately contains the kernel builds and the CUDA-graph
    warm-up and captures, and flagging those as stalls would make
    every cold run report a false positive.

    Backpressure: a role that is about to block on the player↔trainer
    exchange (a full queue, a condition wait) calls :meth:`pause` first —
    waiting for the *other* side is idleness, not a stall, and flagging it
    would blame the healthy role whenever its peer is merely slow. The next
    ``beat``/``resume`` re-arms monitoring. Both sides paused at once cannot
    mask a real deadlock of the exchange itself: the queue cannot be
    simultaneously full (blocking the producer) and empty (blocking the
    consumer), so a wedged side is always the unpaused one.
    """

    def __init__(
        self,
        timeout_s: float = 120.0,
        poll_s: Optional[float] = None,
        on_stall: Optional[Callable[[str, float], None]] = None,
        counters=None,
        warmup_factor: float = 10.0,
    ):
        self.timeout_s = float(timeout_s)
        self.poll_s = float(poll_s) if poll_s else max(min(self.timeout_s / 4.0, 5.0), 0.05)
        self.on_stall = on_stall
        self.warmup_factor = max(float(warmup_factor), 1.0)
        self._counters = counters
        self._beats: Dict[str, float] = {}
        self._beat_counts: Dict[str, int] = {}
        self._flagged: Dict[str, bool] = {}
        self._paused: set = set()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stall_events: list = []

    def register(self, role: str) -> None:
        with self._lock:
            self._beats[role] = time.monotonic()
            self._beat_counts[role] = 0
            self._flagged[role] = False

    def unregister(self, role: str) -> None:
        """A role that finished cleanly must stop being monitored."""
        with self._lock:
            self._beats.pop(role, None)
            self._beat_counts.pop(role, None)
            self._flagged.pop(role, None)
            self._paused.discard(role)

    def beat(self, role: str) -> None:
        with self._lock:
            self._beats[role] = time.monotonic()
            self._beat_counts[role] = self._beat_counts.get(role, 0) + 1
            self._flagged[role] = False
            self._paused.discard(role)

    def pause(self, role: str) -> None:
        """Suspend monitoring while the role blocks on its peer's exchange."""
        with self._lock:
            self._paused.add(role)

    def resume(self, role: str) -> None:
        with self._lock:
            self._beats[role] = time.monotonic()
            self._paused.discard(role)

    @property
    def stalled_roles(self) -> list:
        with self._lock:
            return [r for r, f in self._flagged.items() if f]

    def beat_ages(self) -> Dict[str, Dict[str, object]]:
        """Seconds since each role's last beat (the live snapshot reads
        this): ``{role: {"age_s", "paused", "beats"}}`` — a paused role is
        blocked on its peer's exchange, so its age is idleness, not delay."""
        now = time.monotonic()
        with self._lock:
            return {
                role: {
                    "age_s": round(now - last, 1),
                    "paused": role in self._paused,
                    "beats": self._beat_counts.get(role, 0),
                }
                for role, last in self._beats.items()
            }

    def check(self) -> None:
        """One watchdog pass (the poll thread calls this; tests may too)."""
        now = time.monotonic()
        stalled = []
        with self._lock:
            for role, last in self._beats.items():
                if role in self._paused:
                    continue
                age = now - last
                threshold = self.timeout_s * (
                    self.warmup_factor if self._beat_counts.get(role, 0) < 2 else 1.0
                )
                if age > threshold and not self._flagged[role]:
                    self._flagged[role] = True
                    stalled.append((role, age))
        for role, age in stalled:
            self.stall_events.append((role, age))
            if self._counters is not None:
                self._counters.add("stalls", 1)
            from sheeprl_tpu_torch.obs.spans import get_tracer

            tracer = get_tracer()
            if tracer is not None:
                tracer.instant("stall", args={"role": role, "age_s": round(age, 1)})
            warnings.warn(
                f"run-health: '{role}' has not made progress for {age:.0f}s "
                f"(stall timeout {self.timeout_s:.0f}s) — the thread is likely "
                "wedged on an env worker, a device transfer, or the exchange "
                "queue",
                RuntimeWarning,
            )
            if self.on_stall is not None:
                try:
                    self.on_stall(role, age)
                except Exception:
                    pass

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            self.check()

    def start(self) -> None:
        if self.timeout_s <= 0 or self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="obs-stall-watchdog", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

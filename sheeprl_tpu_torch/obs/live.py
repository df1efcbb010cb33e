"""The live observability plane: streaming run snapshots, an optional
Prometheus endpoint, and the anomaly-triggered flight recorder (counterpart
of ``sheeprl_tpu/obs/live.py``; the same snapshot keys, exposition text and
dump layout).

- :class:`LiveExporter` atomically rewrites ``<log_dir>/telemetry/live.json``
  every ``metric.telemetry.live_interval_s`` seconds: every counter the final
  summary has, plus rolling-window ``sps`` / ``sps_train`` /
  ``bytes_staged_h2d_per_s`` rates, per-phase ``p50/p95/p99``, watchdog beat
  ages, and peak device memory.
- :class:`PromServer` (``metric.telemetry.serve_port``, disabled by default)
  serves the same snapshot as Prometheus text on ``/metrics`` (and the raw
  JSON on ``/``) from a standard-library ``http.server`` daemon thread.
- :class:`FlightRecorder` keeps a bounded in-memory ring of the most recent
  trace events and, when a trigger fires (a span running ``k×`` over its
  running p50 after warmup, a CUDA-graph capture after warm-up, a watchdog
  stall, a non-finite loss, an env worker restart or the pool's fall back to
  in-process stepping, a plane player or replay writer restart), dumps the
  ring plus a counter snapshot to ``telemetry/flight_<reason>_<step>.json``.
  With ``flight.profiler_capture_s > 0`` a dump also opens a
  ``torch.profiler`` window of that many seconds (on the loop's thread,
  arbitrated with the scheduled captures: ``obs/prof/capture.py``) whose
  Chrome trace lands in ``flight_<reason>_<step>_trace/`` and whose parse,
  ``flight_<reason>_<step>_trace_summary.json``, beside it.

Everything here is owned by :class:`~sheeprl_tpu_torch.obs.telemetry.Telemetry`;
none of it exists (no threads, no sockets, no ring allocation) when
``metric.telemetry`` is off.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Callable, Dict, Optional

from sheeprl_tpu_torch.obs.dist.aggregate import atomic_write_json

__all__ = [
    "FlightRecorder",
    "LiveExporter",
    "PromServer",
    "atomic_write_json",
    "prometheus_text",
]


# -- rolling snapshots --------------------------------------------------------


class LiveExporter:
    """Periodic atomic writer of the live run snapshot.

    ``snapshot_fn`` returns the full summary dict (the telemetry owns what
    goes in it); the exporter layers the rolling-window rates and a
    liveness header on top, then writes atomically. One snapshot is written
    immediately at start (so even a run shorter than one interval leaves a
    ``live.json``) and one final snapshot at stop.

    Rolling rates are computed over ``window_s`` of samples. The step totals
    advance at the algorithms' log boundaries (``metric.log_every``), so the
    rolling ``sps`` granularity is the log cadence; the byte/transfer
    counters advance continuously.
    """

    def __init__(
        self,
        snapshot_fn: Callable[[], Dict[str, Any]],
        path: str,
        interval_s: float = 30.0,
        window_s: float = 60.0,
    ):
        self.snapshot_fn = snapshot_fn
        self.path = path
        self.interval_s = float(interval_s)
        self.window_s = float(window_s)
        self.writes = 0
        self._samples: collections.deque = collections.deque()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._latest: Optional[Dict[str, Any]] = None
        self._latest_t = 0.0

    # -- snapshot assembly ---------------------------------------------------

    def _rolling(self, now: float, snap: Dict[str, Any]) -> Dict[str, Any]:
        self._samples.append(
            (
                now,
                snap.get("policy_steps") or 0,
                snap.get("train_steps") or 0,
                snap.get("bytes_staged_h2d") or 0,
            )
        )
        while len(self._samples) > 2 and now - self._samples[0][0] > self.window_s:
            self._samples.popleft()
        t0, p0, tr0, b0 = self._samples[0]
        dt = now - t0
        if dt <= 0 or len(self._samples) < 2:
            return {"window_s": None, "sps": None, "sps_train": None, "bytes_staged_h2d_per_s": None}
        _, p1, tr1, b1 = self._samples[-1]
        return {
            "window_s": round(dt, 1),
            "sps": round((p1 - p0) / dt, 3),
            "sps_train": round((tr1 - tr0) / dt, 3),
            "bytes_staged_h2d_per_s": round((b1 - b0) / dt, 1),
        }

    def snapshot(self) -> Dict[str, Any]:
        """Assemble (and remember) one live snapshot."""
        snap = self.snapshot_fn()
        snap["ts_unix"] = round(time.time(), 3)
        with self._lock:  # scrape threads may assemble too — samples shared
            now = time.monotonic()
            snap["rolling"] = self._rolling(now, snap)
            self._latest = snap
            self._latest_t = now
        return snap

    def latest(self) -> Optional[Dict[str, Any]]:
        """The most recent snapshot (the Prometheus endpoint reads this)."""
        with self._lock:
            return self._latest

    def latest_or_fresh(self) -> Dict[str, Any]:
        """The cached snapshot while the exporter thread keeps it current;
        a freshly computed one in serve-only mode (``interval_s=0`` — no
        thread refreshes the cache, so serving it would freeze the endpoint
        at the first scrape forever). A small staleness cap bounds the
        recompute rate so a scrape storm still cannot add load."""
        with self._lock:
            latest, latest_t = self._latest, self._latest_t
        if self._thread is not None and latest is not None:
            return latest
        if latest is not None and time.monotonic() - latest_t < 1.0:
            return latest
        return self.snapshot()

    def write_once(self) -> Dict[str, Any]:
        snap = self.snapshot()
        try:
            atomic_write_json(self.path, snap)
            self.writes += 1
        except OSError:
            pass  # a full/read-only disk must not take the run down
        return snap

    # -- lifecycle -----------------------------------------------------------

    def _run(self) -> None:
        self.write_once()
        while not self._stop.wait(self.interval_s):
            self.write_once()

    def start(self) -> None:
        if self.interval_s <= 0 or self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="obs-live-exporter", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
            self.write_once()  # final state visible after the run ends


# -- Prometheus text endpoint -------------------------------------------------


def _prom_name(key: str) -> str:
    out = []
    for ch in key:
        out.append(ch if ch.isalnum() or ch == "_" else "_")
    name = "".join(out)
    return name if not name or not name[0].isdigit() else f"_{name}"


def prometheus_text(snap: Dict[str, Any], prefix: str = "sheeprl") -> str:
    """Render a live snapshot as Prometheus exposition text (gauges).

    Scalars become ``<prefix>_<key>``; the per-phase percentile map becomes
    ``<prefix>_phase_duration_ms{phase="...",quantile="..."}`` plus a
    ``.._count`` series; rolling rates ``<prefix>_rolling_<key>``. The
    distributed sections (obs/dist) label instead of flattening: per-kind
    collectives as ``<prefix>_comms_*{kind="..."}``, staleness percentiles
    as ``<prefix>_sample_age_seconds{quantile="..."}`` /
    ``<prefix>_policy_lag_versions{quantile="..."}``, queue gauges as
    ``<prefix>_queue_depth{queue="..."}``, and every merged source
    process's numeric counters as ``<prefix>_<key>{source="player0"}``.
    The learning-health plane (obs/learn) exports its per-probe baselines —
    including the per-module grad norms — as
    ``<prefix>_learn_probe{probe="learn/grad_norm/actor",stat="p95"}``
    (the headline ``learn_warnings`` / ``learn_criticals`` /
    ``grad_norm_p95`` / ``update_ratio_p50`` ride the flat-scalar path).
    """
    lines = []

    def emit(name: str, value, labels: str = "") -> None:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            return
        lines.append(f"{prefix}_{name}{labels} {float(value):g}")

    skip = (
        "phase_percentiles",
        "rolling",
        "watchdog_beat_age_s",
        "comms",
        "staleness",
        "sources",
        "learn",
        "serve_versions",
        "slo",
        "replay_shard_fill",
    )
    for key, value in sorted(snap.items()):
        if key in skip:
            continue
        emit(_prom_name(key), value)
    for key, value in (snap.get("rolling") or {}).items():
        emit(f"rolling_{_prom_name(key)}", value)
    for role, info in (snap.get("watchdog_beat_age_s") or {}).items():
        age = info.get("age_s") if isinstance(info, dict) else info
        emit("watchdog_beat_age_seconds", age, '{role="%s"}' % role)
    for phase, pct in (snap.get("phase_percentiles") or {}).items():
        emit("phase_duration_count", pct.get("count"), '{phase="%s"}' % phase)
        for q_key, q in (("p50_ms", "0.5"), ("p95_ms", "0.95"), ("p99_ms", "0.99")):
            emit(
                "phase_duration_ms",
                pct.get(q_key),
                '{phase="%s",quantile="%s"}' % (phase, q),
            )
    for kind, rec in sorted((snap.get("comms") or {}).items()):
        lbl = '{kind="%s"}' % kind
        emit("comms_kind_ops", rec.get("ops"), lbl)
        emit("comms_kind_bytes", rec.get("bytes"), lbl)
        emit("comms_kind_ms", rec.get("ms"), lbl)
        emit("comms_achieved_gbps", rec.get("last_gbps"), lbl)
    stale = snap.get("staleness") or {}
    for section, series, unit in (
        ("sample_age_s", "sample_age_seconds", "s"),
        ("policy_lag_versions", "policy_lag_versions", "v"),
    ):
        pct = stale.get(section) or {}
        emit(f"{series}_count", pct.get("count"))
        for q_key, q in ((f"p50_{unit}", "0.5"), (f"p95_{unit}", "0.95"), (f"p99_{unit}", "0.99")):
            emit(series, pct.get(q_key), '{quantile="%s"}' % q)
    for queue, gauge in sorted((stale.get("queue_depth") or {}).items()):
        emit("queue_depth", gauge.get("last"), '{queue="%s"}' % queue)
        emit("queue_depth_max", gauge.get("max"), '{queue="%s"}' % queue)
    # sharded replay plane (sheeprl_tpu_torch/replay): fill fraction per host shard
    for shard, fill in sorted((snap.get("replay_shard_fill") or {}).items()):
        emit("replay_shard_fill", fill, '{shard="%s"}' % shard)
    lrn = snap.get("learn") or {}
    emit("learn_bursts_observed", lrn.get("bursts_observed"))
    for probe, rec in sorted((lrn.get("probes") or {}).items()):
        emit("learn_probe_count", rec.get("n"), '{probe="%s"}' % probe)
        for stat in ("last", "p50", "p95", "max"):
            emit(
                "learn_probe",
                rec.get(stat),
                '{probe="%s",stat="%s"}' % (probe, stat),
            )
    for source, src_snap in sorted((snap.get("sources") or {}).items()):
        if not isinstance(src_snap, dict):
            continue
        lbl = '{source="%s"}' % source
        for key, value in sorted(src_snap.items()):
            emit(_prom_name(key), value, lbl)
    # serving-tier sections (serve/ops.py snapshots): per-version request /
    # latency breakdown and the SLO engine's burn rates + alert states
    for ver, rec in sorted((snap.get("serve_versions") or {}).items()):
        lbl = '{version="%s"}' % ver
        emit("serve_version_requests", rec.get("requests"), lbl)
        for q_key, q in (("p50_ms", "0.5"), ("p95_ms", "0.95"), ("p99_ms", "0.99")):
            emit(
                "serve_version_latency_ms",
                rec.get(q_key),
                '{version="%s",quantile="%s"}' % (ver, q),
            )
    slo = snap.get("slo") or {}
    emit("slo_cancelled_tickets", slo.get("cancelled_tickets"))
    emit("slo_alerts_fired", slo.get("alerts_fired"))
    for name, rec in sorted((slo.get("objectives") or {}).items()):
        lbl = '{objective="%s"}' % name
        emit("slo_burn_rate_fast", rec.get("burn_fast"), lbl)
        emit("slo_burn_rate_slow", rec.get("burn_slow"), lbl)
        emit("slo_alert_active", int(bool(rec.get("fast_active"))), '{objective="%s",alert="fast_burn"}' % name)
        emit("slo_alert_active", int(bool(rec.get("slow_active"))), '{objective="%s",alert="slow_burn"}' % name)
        emit("slo_objective_ok", int(rec.get("verdict") == "PASS"), lbl)
    return "\n".join(lines) + "\n"


class PromServer:
    """A stdlib HTTP daemon serving ``/metrics`` (Prometheus text) and ``/``
    (the raw live JSON) from the exporter's latest snapshot.

    ``port=0`` binds an ephemeral port (tests); the bound port is ``.port``.
    The server never computes a snapshot itself — a scrape returns the
    exporter's most recent one, so a scrape storm cannot add load to the run.
    """

    def __init__(self, exporter: LiveExporter, port: int, host: str = ""):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                snap = outer.exporter.latest_or_fresh()
                if self.path.startswith("/metrics"):
                    body = prometheus_text(snap).encode()
                    ctype = "text/plain; version=0.0.4"
                else:
                    body = (json.dumps(snap, indent=2, sort_keys=True) + "\n").encode()
                    ctype = "application/json"
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # scrapes must not spam the run log
                pass

        self.exporter = exporter
        self._server = ThreadingHTTPServer((host, int(port)), Handler)
        self._server.daemon_threads = True
        self.port = int(self._server.server_address[1])
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="obs-prom-endpoint",
            daemon=True,
        )
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)
        self._thread = None


# -- flight recorder ----------------------------------------------------------


class FlightRecorder:
    """Bounded ring of recent trace events, dumped at the moment of an
    anomaly.

    :meth:`record` is the ring feed — the :class:`~sheeprl_tpu_torch.obs.spans.
    TraceWriter` calls it for every event it emits (the ring works even with
    the trace *file* disabled, e.g. bench runs). :meth:`trigger` dumps
    ``telemetry/flight_<reason>_<step>.json``: the ring, a counter snapshot,
    the per-phase percentiles, and the trigger detail. Dumps are
    rate-limited (``min_interval_s`` between dumps, ``max_dumps`` per run) so
    a pathological run leaves a handful of evidence files, not a disk full.
    """

    def __init__(
        self,
        capacity: int = 2048,
        min_interval_s: float = 30.0,
        max_dumps: int = 8,
        out_dir: Optional[str] = None,
        step_source: Optional[Callable[[], int]] = None,
        context_fn: Optional[Callable[[], Dict[str, Any]]] = None,
        tag: str = "",
        profiler_capture_s: float = 0.0,
    ):
        self.ring: collections.deque = collections.deque(maxlen=int(capacity))
        self.profiler_capture_s = float(profiler_capture_s or 0.0)
        self._capturing = False
        self._window = None
        self.min_interval_s = float(min_interval_s)
        self.max_dumps = int(max_dumps)
        self.out_dir = out_dir
        self.step_source = step_source
        self.context_fn = context_fn
        self.tag = tag  # per-rank suffix so shared run dirs don't collide
        self.dumps = 0
        self.suppressed = 0
        self.dump_files: list = []
        self._lock = threading.Lock()
        self._last_dump_t = 0.0
        self._suppressed_since_dump = 0

    def attach_dir(self, out_dir: str, tag: str = "") -> None:
        self.out_dir = out_dir
        self.tag = tag

    def record(self, event: Dict[str, Any]) -> None:
        """Append one trace event (deque.append is atomic — no lock)."""
        self.ring.append(event)

    # -- triggers ------------------------------------------------------------

    def trigger(self, reason: str, detail: Dict[str, Any]) -> Optional[str]:
        """Fire the recorder; returns the dump path (None when rate-limited
        or no run dir is attached yet)."""
        now = time.monotonic()
        with self._lock:
            if (
                self.out_dir is None
                or self.dumps >= self.max_dumps
                or (self._last_dump_t and now - self._last_dump_t < self.min_interval_s)
            ):
                self.suppressed += 1
                self._suppressed_since_dump += 1
                return None
            # _last_dump_t advances even if the write below fails: a full
            # disk must not turn every trigger into a write attempt
            self._last_dump_t = now
            self.dumps += 1
            suppressed_before = self._suppressed_since_dump
            self._suppressed_since_dump = 0
        # other threads keep appending trace events while we snapshot the
        # ring (record() is lock-free by design); deque iteration raises
        # RuntimeError on concurrent mutation, so retry a few times
        events: list = []
        for _ in range(8):
            try:
                events = list(self.ring)
                break
            except RuntimeError:
                continue
        step = 0
        if self.step_source is not None:
            try:
                step = int(self.step_source())
            except Exception:
                pass
        stem = f"flight_{reason}_{step}{self.tag}"
        path = os.path.join(self.out_dir, f"{stem}.json")
        k = 1
        while os.path.exists(path):
            path = os.path.join(self.out_dir, f"{stem}_{k}.json")
            k += 1
        payload: Dict[str, Any] = {
            "reason": reason,
            "detail": detail,
            "step": step,
            "ts_unix": round(time.time(), 3),
            # triggers rate-limited away since the previous dump — an
            # operator reading one dump of a storm sees the storm's size
            "suppressed_before": suppressed_before,
            "events": events,
        }
        if self.context_fn is not None:
            try:
                payload["context"] = self.context_fn()
            except Exception:
                pass
        try:
            atomic_write_json(path, payload)
        except OSError:
            with self._lock:  # nothing landed: give the budget back
                self.dumps -= 1
            return None
        self.dump_files.append(path)
        from sheeprl_tpu_torch.obs.spans import get_tracer

        tracer = get_tracer()
        if tracer is not None:
            tracer.instant(f"flight_{reason}", cat="flight", args=detail)
        if self.profiler_capture_s > 0:
            self._capture_window(f"{path[:-5]}_trace")
        return path

    def _capture_window(self, out_dir: str) -> None:
        """A profiler window of ``profiler_capture_s`` seconds, opened on the
        loop's thread (now, or at its next span when the trigger fired
        elsewhere) if no other capture holds the profiler; its trace is
        parsed and folded into the run telemetry as it lands."""
        from sheeprl_tpu_torch.obs.prof import capture as _capture

        with self._lock:
            if self._capturing:
                return
            self._capturing = True

        def on_done(events, window) -> Optional[Dict[str, Any]]:
            with self._lock:
                self._capturing = False
            if not events:
                return None
            from sheeprl_tpu_torch.obs.telemetry import get_telemetry

            record = _capture.parse_and_fold(events, get_telemetry())
            if record is not None:
                record["trace_dir"] = out_dir
                record["kernel_launches"] = dict(window.launches)
                try:
                    atomic_write_json(f"{out_dir}_summary.json", record)
                except OSError:
                    pass
            return record

        def opener() -> None:
            self._window = _capture.open_window(out_dir, self.profiler_capture_s, on_done)
            if self._window is None:
                with self._lock:
                    self._capturing = False

        if not _capture.queue_window(opener):
            with self._lock:
                self._capturing = False

    def close_capture(self) -> None:
        """Stop an open anomaly window (on its own thread) and wait for its parse."""
        window, self._window = self._window, None
        if window is not None:
            window.stop()
            window.wait()

"""The gateway's ops surface (counterpart of ``sheeprl_tpu/serve/ops.py``):
tracing, the SLO engine, the access log and ``/metrics``.

One :class:`ServeOps` a gateway composes the request-path planes of
``obs/``:

- a :class:`~sheeprl_tpu_torch.obs.reqtrace.ServeTracer` (two Chrome-trace
  lanes, client and gateway pids, ``trace_serve_*.jsonl``, merged with a
  run's trace by ``sheeprl_tpu_torch/tools/trace_view.py``);
- a :class:`~sheeprl_tpu_torch.obs.slo.SloEngine` evaluated on a daemon
  tick of its own, fed each retired request by the batcher and each tick
  the gateway's swap staleness; an alert's firing lands in
  ``alerts.jsonl`` and trips the flight recorder (``reason=slo_burn``);
- a sampled JSONL **access log** (``access.jsonl``: one line per k-th
  retired request);
- a :class:`~sheeprl_tpu_torch.obs.live.PromServer` over a serve-only
  :class:`~sheeprl_tpu_torch.obs.live.LiveExporter` (``interval_s=0``: a
  scrape recomputes the snapshot at most once a second) with the
  per-version requests and latency, the stages' percentiles, the batch
  occupancy and the SLO burn rates on ``/metrics``; the same snapshot is
  written to ``serve_live.json`` at drain for
  ``sheeprl_tpu_torch/tools/serve_report.py``.

Each knob turns its part on (``configs/serve/default.yaml``):
:meth:`ServeOps.build` returns None when none is on, and the batcher then
has no sink, so the request path is the one without ops. Nothing here
computes on the device, and the module imports no torch.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Callable, Dict, Optional

from sheeprl_tpu_torch.obs.reqtrace import now as _now
from sheeprl_tpu_torch.obs.reqtrace import sample_every
from sheeprl_tpu_torch.obs.reqtrace import unix_now as _unix_now

__all__ = ["AccessLog", "ServeOps"]


class AccessLog:
    """Sampled JSONL request log: every k-th retired request, one line."""

    def __init__(self, path: str, sample_rate: float):
        self._every = sample_every(sample_rate)
        self._lock = threading.Lock()
        self._seen = 0
        self.written = 0
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
        self._file = open(path, "a")

    def maybe_log(self, record: Dict[str, Any]) -> None:
        if self._every <= 0:
            return
        with self._lock:
            self._seen += 1
            if (self._seen - 1) % self._every:
                return
            if self._file.closed:
                return
            self._file.write(json.dumps(record) + "\n")
            self.written += 1
            if self.written % 64 == 0:
                self._file.flush()

    def close(self) -> None:
        with self._lock:
            if not self._file.closed:
                self._file.flush()
                self._file.close()


class ServeOps:
    """Per-gateway composition of the request-path observability planes."""

    def __init__(
        self,
        settings: Dict[str, Any],
        out_dir: str,
        status_fn: Callable[[], Dict[str, Any]],
        staleness_fn: Optional[Callable[[], float]] = None,
    ):
        from sheeprl_tpu_torch.obs.slo import SloEngine, slo_settings

        self.out_dir = os.path.abspath(out_dir)
        os.makedirs(self.out_dir, exist_ok=True)
        self._status_fn = status_fn
        self._staleness_fn = staleness_fn
        self.inject_dispatch_delay_s = float(
            settings.get("inject_dispatch_delay_s") or 0.0
        )
        # the flight recorder: the run's (telemetry on), else one of its own,
        # so that a bare gateway still dumps flight_slo_burn_*.json
        self.flight = None
        self._own_flight = False
        try:
            from sheeprl_tpu_torch.obs.telemetry import get_telemetry

            tel = get_telemetry()
            if tel is not None and tel.flight is not None:
                self.flight = tel.flight
        except Exception:
            pass
        if self.flight is None:
            from sheeprl_tpu_torch.obs.live import FlightRecorder

            self.flight = FlightRecorder(
                capacity=2048, min_interval_s=5.0, max_dumps=8, out_dir=self.out_dir
            )
            self._own_flight = True
        # tracing
        self.tracer = None
        rate = float(settings.get("trace_sample_rate") or 0.0)
        if rate > 0:
            from sheeprl_tpu_torch.obs import reqtrace

            self.tracer = reqtrace.ServeTracer(self.out_dir, rate, flight_ring=self.flight)
            reqtrace.install(self.tracer)
        # access log
        self.access = None
        access_rate = float(settings.get("access_log_sample_rate") or 0.0)
        if access_rate > 0:
            self.access = AccessLog(os.path.join(self.out_dir, "access.jsonl"), access_rate)
        # SLO engine + its evaluation tick
        self.slo = None
        self._slo_stop = threading.Event()
        self._slo_thread = None
        slo_cfg = slo_settings(settings.get("slo"))
        if bool(slo_cfg.get("enabled")):
            self.slo = SloEngine(
                slo_cfg,
                alerts_path=os.path.join(self.out_dir, "alerts.jsonl"),
                on_alert=self._on_alert,
                clock=_now,
            )
            self._slo_thread = threading.Thread(
                target=self._slo_loop, name="serve-slo", daemon=True
            )
            self._slo_thread.start()
        # live snapshot + optional /metrics endpoint
        from sheeprl_tpu_torch.obs.live import LiveExporter

        self.exporter = LiveExporter(
            self.snapshot,
            path=os.path.join(self.out_dir, "serve_live.json"),
            interval_s=0.0,  # serve-only mode: scrapes recompute, <= 1/s
        )
        self.prom = None
        metrics_port = settings.get("metrics_port")
        if metrics_port is not None:
            from sheeprl_tpu_torch.obs.live import PromServer

            self.prom = PromServer(self.exporter, port=int(metrics_port))
            self.prom.start()

    @classmethod
    def build(
        cls,
        settings: Dict[str, Any],
        out_dir: str,
        status_fn: Callable[[], Dict[str, Any]],
        staleness_fn: Optional[Callable[[], float]] = None,
    ) -> Optional["ServeOps"]:
        """A :class:`ServeOps` when any ops knob is on, else None (the off
        state: the batcher never gets a sink)."""
        slo_cfg = dict(settings.get("slo") or {})
        enabled = (
            float(settings.get("trace_sample_rate") or 0.0) > 0
            or float(settings.get("access_log_sample_rate") or 0.0) > 0
            or float(settings.get("inject_dispatch_delay_s") or 0.0) > 0
            or bool(slo_cfg.get("enabled"))
            or settings.get("metrics_port") is not None
        )
        if not enabled:
            return None
        return cls(settings, out_dir, status_fn, staleness_fn=staleness_fn)

    # -- request-path feed (called by the batcher's dispatcher thread) -------

    def on_request(
        self,
        client_id: str,
        latency_s: Optional[float],
        version: int,
        ok: bool = True,
        trace=None,
        stamps=None,
        rows: int = 0,
    ) -> None:
        """One retired ticket: feed the SLO engine and the access log and,
        for a sampled request, write its six-stage span chain."""
        if self.slo is not None:
            self.slo.record_request(latency_s, failed=not ok)
        tracer = self.tracer
        if tracer is not None and trace is not None and ok and stamps is not None:
            t_submit, t_collect, t_model, t_done, t_end = stamps
            tracer.emit_request(
                trace,
                t_submit,
                t_collect,
                t_model,
                t_done,
                t_end,
                client_id=client_id,
                version=version,
            )
        if self.access is not None:
            self.access.maybe_log(
                {
                    "ts_unix": round(_unix_now(), 6),
                    "client": str(client_id),
                    "latency_ms": round(latency_s * 1e3, 3) if latency_s is not None else None,
                    "version": int(version),
                    "ok": bool(ok),
                    "trace_id": int(trace.trace_id) if trace is not None else 0,
                    "batch_rows": int(rows),
                }
            )

    def on_cancelled(self, n: int) -> None:
        if self.slo is not None:
            for _ in range(int(n)):
                self.slo.record_request(None, cancelled=True)

    # -- SLO tick ------------------------------------------------------------

    def _slo_loop(self) -> None:
        interval = float(self.slo.settings.get("eval_interval_s") or 1.0)
        while not self._slo_stop.wait(interval):
            self.slo_tick()

    def slo_tick(self) -> None:
        """One evaluation tick (also the test hook): sample the staleness
        gauge, then update every burn-rate alert pair."""
        if self.slo is None:
            return
        try:
            if self._staleness_fn is not None:
                self.slo.record_staleness(float(self._staleness_fn()))
            self.slo.evaluate()
        except Exception:
            pass  # observability must never take the gateway down

    def _on_alert(self, rec: Dict[str, Any]) -> None:
        from sheeprl_tpu_torch.obs.counters import add_slo_alert

        add_slo_alert(1)
        if self.flight is not None:
            try:
                self.flight.trigger("slo_burn", rec)
            except Exception:
                pass

    # -- the ops snapshot (PromServer /metrics + serve_live.json) ------------

    def snapshot(self) -> Dict[str, Any]:
        """Gateway status adapted to the live-exporter shape: flat scalars,
        per-stage percentiles under ``phase_percentiles`` (so they export as
        ``phase_duration_ms{phase="serve/..."}``), the per-version breakdown
        under ``serve_versions``, and the SLO engine under ``slo``."""
        status = dict(self._status_fn() or {})
        snap: Dict[str, Any] = {
            k: v for k, v in status.items() if isinstance(v, (int, float, bool))
        }
        phase: Dict[str, Any] = {}
        lat = status.get("act_latency")
        if isinstance(lat, dict):
            phase["serve/act_latency"] = lat
        for name, pct in (status.get("stage_latency") or {}).items():
            phase[f"serve/{name}"] = pct
        snap["phase_percentiles"] = phase
        occ = status.get("batch_occupancy") or {}
        for key in ("p50", "p95", "p99", "max"):
            if occ.get(key) is not None:
                snap[f"batch_occupancy_{key}"] = occ[key]
        snap["serve_versions"] = status.get("versions") or {}
        if self.tracer is not None:
            snap["trace_sampled_requests"] = self.tracer.sampled
        if self.access is not None:
            snap["access_log_lines"] = self.access.written
        if self.slo is not None:
            snap["slo"] = self.slo.status()
        snap["ts_unix"] = round(_unix_now(), 3)
        return snap

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        """Drain-time teardown: final SLO tick, final snapshot to disk, stop
        the metrics server, flush every sink."""
        self._slo_stop.set()
        if self._slo_thread is not None:
            self._slo_thread.join(timeout=10.0)
        self.slo_tick()  # final evaluation so late burns still alert
        try:
            self.exporter.write_once()
        except Exception:
            pass
        if self.prom is not None:
            try:
                self.prom.stop()
            except Exception:
                pass
        if self.tracer is not None:
            from sheeprl_tpu_torch.obs import reqtrace

            if reqtrace.installed() is self.tracer:
                reqtrace.install(None)
            self.tracer.close()
        if self.access is not None:
            self.access.close()
        if self.slo is not None:
            self.slo.close()

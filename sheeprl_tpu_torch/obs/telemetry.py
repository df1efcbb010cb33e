"""The run telemetry object: configuration, lifecycle, and the end-of-run
summary (``telemetry.json``); counterpart of ``sheeprl_tpu/obs/telemetry.py``,
with the JAX package's summary keys plus ``graph_replays``.

One :class:`Telemetry` exists per training run, configured from the
``metric.telemetry`` config group and owned by the CLI
(:func:`sheeprl_tpu_torch.cli.run_algorithm` calls :func:`setup_telemetry` before
launching and :func:`finalize_telemetry` after). Algorithms and the data
layer never see the object directly — they use :func:`get_telemetry` (None
when disabled), the :class:`~sheeprl_tpu_torch.obs.spans.span` scopes, and the
counter helpers, all of which are no-ops in un-instrumented runs.

On finalize the run's aggregate health is printed and written as
``telemetry.json`` next to the checkpoint dir (``<log_dir>/telemetry.json``):

========================  ====================================================
key                       meaning
========================  ====================================================
``run_wall_s``            wall seconds between setup and finalize
``policy_steps``          per-process env steps accounted at log boundaries
``train_steps``           gradient steps accounted at log boundaries
``sps``                   policy_steps / run_wall_s (whole-run average)
``sps_env``               policy_steps / timed env-interaction seconds
``sps_train``             train_steps / timed train seconds
``mfu``                   % of ``peak_tflops`` (default: the H100 SXM's dense
                          bf16 peak, 989.4) sustained during timed train
                          seconds (null until a loop registers step FLOPs)
``bytes_staged_h2d``      bytes shipped host→device through the staging paths
``h2d_transfers``         number of staged transfers
``recompiles``            CUDA-graph captures
``compile_secs``          host seconds of the captured steps' warm-up calls
                          and captures
``compile_cache_hits``    kernel libraries loaded without a build
``graph_replays``         CUDA-graph replays
``peak_hbm_bytes``        the allocator's peak allocated bytes on the card
                          (``torch.cuda.max_memory_allocated``; 0 on the CPU)
``hbm_bytes_limit``       the card's memory (0 on the CPU)
``nonfinite_metrics``     NaN/inf values caught by the loss guard
``learn_warnings``        warn-grade learning-health events (``obs/learn``)
``learn_criticals``       critical-grade learning-health events (sustained
                          explosion before a NaN, non-finite gradients)
``learn_probe_fetches``   device→host pulls of learn probes (one a burst at
                          the sentinel's cadence; 0 with the probes off)
``grad_norm_p95``         p95 of the global gradient norm over the run
``update_ratio_p50``      p50 of the update-to-weight ratio
``learn``                 the sentinel's sub-dict: event list, per-probe
                          baselines (n, last, p50, p95, max)
``stalls``                watchdog stall episodes
``ckpt_blocked_ms``       train-step wall ms blocked on checkpoints (host
                          snapshot + double-buffer wait — the step-path cost)
``ckpt_write_ms``         writer-thread ms spent serializing/fsyncing saves
``ckpt_bytes``            checkpoint bytes landed on disk
``ckpt_saves``            completed checkpoint writes
``ckpt_failures``         writes that exhausted their retry budget
``env_steps_async``       env steps served by the async shared-memory pool
``env_worker_restarts``   env workers restarted after a crash/hang
``env_degraded_to_sync``  1 when the pool exhausted its restart budget and
                          fell back to in-process sync stepping
``phase_percentiles``     per-phase ``p50/p95/p99`` span durations (ms) from
                          the streaming histograms (``obs/hist.py``)
``device_ms_per_step``    profiled device time per train-step unit from the
                          latest in-run capture (``obs/prof``; null until a
                          ``metric.telemetry.profile`` window landed)
``mfu_device_pct``        the captured train step's FLOPs over its device
                          time, % of the card's peak
``roofline_verdict``      compute-bound / memory-bound / dispatch-bound /
                          unknown / unmeasured for the captured train step
                          (its FLOP rate against the peak of its compute
                          type, ``prof.compute_dtype``)
``prof_captures``         in-run profile captures parsed this run
``prof``                  the latest capture's detail (train module, busy
                          share, bandwidth, the window's kernel counts), or
                          when every capture failed, their count and the
                          last reason (a card's window with no device event)
``flight_dumps``          flight-recorder evidence files written
``crashed``               True when the entrypoint raised; ``exception``
                          then carries the type and message
========================  ====================================================

The same object owns the **live plane** (``obs/live.py``): a periodic
exporter that atomically rewrites ``telemetry/live.json`` with this summary
plus rolling-window rates and watchdog beat ages, an optional Prometheus
endpoint, and the anomaly-triggered flight recorder.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Optional

from sheeprl_tpu_torch.obs import counters as _counters
from sheeprl_tpu_torch.obs import hist as _hist
from sheeprl_tpu_torch.obs.health import NonFiniteGuard, StallWatchdog
from sheeprl_tpu_torch.obs.live import FlightRecorder, LiveExporter, PromServer, atomic_write_json
from sheeprl_tpu_torch.obs.perf import PEAK_TFLOPS_BF16, mfu_pct
from sheeprl_tpu_torch.obs.spans import TraceWriter, set_tracer

__all__ = ["Telemetry", "setup_telemetry", "get_telemetry", "finalize_telemetry"]

_ACTIVE: Optional["Telemetry"] = None


def get_telemetry() -> Optional["Telemetry"]:
    """The active run telemetry, or None when disabled."""
    return _ACTIVE


class Telemetry:
    """``device`` is the run's device (the memory poller samples a CUDA one),
    ``rank`` the fabric's process rank (the trace's ``pid``)."""

    def __init__(self, tcfg: Optional[Dict[str, Any]] = None, device: Any = None, rank: int = 0):
        tcfg = dict(tcfg or {})
        self.device = device
        #: the run's ``fabric.precision`` (set by :func:`setup_telemetry`)
        self.precision: Optional[str] = None
        self.cfg = tcfg
        self.trace_enabled = bool(tcfg.get("trace", True))
        self.trace_file: Optional[str] = tcfg.get("trace_file") or None
        self.xla_annotations = bool(tcfg.get("xla_annotations", True))
        self.poll_interval_s = float(tcfg.get("poll_interval_s", 5.0) or 0.0)
        self.stall_timeout_s = float(tcfg.get("stall_timeout_s", 120.0) or 0.0)
        self.summary_enabled = bool(tcfg.get("summary", True))
        self.summary_path: Optional[str] = tcfg.get("summary_path") or None
        self.peak_tflops = float(tcfg.get("peak_tflops", PEAK_TFLOPS_BF16))
        # live plane (obs/live.py)
        self.live_interval_s = float(tcfg.get("live_interval_s", 30.0) or 0.0)
        self.live_window_s = float(tcfg.get("live_window_s", 60.0) or 60.0)
        self.serve_port: Optional[int] = (
            int(tcfg.get("serve_port") or 0) or None
        )
        self.histograms_enabled = bool(tcfg.get("histograms", True))
        self.staleness_enabled = bool(tcfg.get("staleness", True))
        self._flight_cfg = dict(tcfg.get("flight", {}) or {})
        self._profile_cfg = dict(tcfg.get("profile", {}) or {})
        self.sentinel = None  # LearnSentinel (obs/learn), built in start()

        self.counters = _counters.Counters()
        self.staleness = None  # StalenessTracker, built in start()
        self.tracer: Optional[TraceWriter] = None
        self.poller: Optional[_counters.DevicePoller] = None
        self.guard: Optional[NonFiniteGuard] = None
        self.hists: Optional[_hist.HistogramSet] = None
        self.flight: Optional[FlightRecorder] = None
        self.live: Optional[LiveExporter] = None
        self.prom: Optional[PromServer] = None
        self.run_dir: Optional[str] = None
        self._rank = int(rank)
        self._watchdogs: list[StallWatchdog] = []
        self._t_start = time.perf_counter()
        self._finalized = False
        self._printed_trace_note = False

        # accumulated at log boundaries by perf.log_sps_metrics
        self.policy_steps = 0
        self.train_steps = 0
        self.env_seconds = 0.0
        self.train_seconds = 0.0
        self.stage_seconds = 0.0
        #: FLOPs per *unit of the train-step counter* (obs.perf.register_train_cost):
        #: `flops_per_train_step × Δtrain_step` is the FLOPs the card ran, the
        #: MFU numerator against `peak_tflops`
        self.flops_per_train_step: Optional[float] = None
        #: bytes per train-step unit (the same convention): the bandwidth
        #: numerator of the in-run roofline (obs/prof)
        self.bytes_per_train_step: Optional[float] = None
        #: step calls per train-step unit
        self.dispatches_per_train_step = 1
        self._flops_attempted = False
        # in-run device-profile capture (obs/prof/capture.py); built in
        # start() so profile_tick is a no-op on un-instrumented runs
        self.prof = None
        self._prof_last: Optional[Dict[str, Any]] = None
        #: last world_size seen at a profile_tick: anomaly-capture parses
        #: (obs/prof.parse_and_fold) scale per-unit numbers with it
        self.last_world_size = 1

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        from sheeprl_tpu_torch.obs.dist import aggregate as _aggregate
        from sheeprl_tpu_torch.obs.dist import staleness as _staleness
        from sheeprl_tpu_torch.obs.prof import capture as _capture

        self.prof = _capture.StepProfiler(self._profile_cfg, self)
        # the thread that runs the loop opens the profiler windows queued by
        # triggers on other threads (a session stops only where it started)
        _capture.set_loop_thread(threading.get_ident())
        _counters.install(self.counters)
        _aggregate.clear_sources()
        if self.staleness_enabled:
            self.staleness = _staleness.StalenessTracker()
            _staleness.install(self.staleness)
        if self.poll_interval_s > 0:
            devices = [self.device] if self.device is not None and str(self.device).startswith("cuda") else []
            self.poller = _counters.DevicePoller(self.poll_interval_s, devices=devices)
            self.poller.start()
        fcfg = self._flight_cfg
        if bool(fcfg.get("enabled", True)):
            self.flight = FlightRecorder(
                capacity=int(fcfg.get("ring_events", 2048)),
                min_interval_s=float(fcfg.get("min_interval_s", 30.0)),
                max_dumps=int(fcfg.get("max_dumps", 8)),
                profiler_capture_s=float(fcfg.get("profiler_capture_s", 0.0) or 0.0),
                step_source=lambda: self.policy_steps,
                context_fn=self._flight_context,
            )
            self._recompile_warmup_s = float(fcfg.get("recompile_warmup_s", 120.0))
            _counters.set_compile_hook(self._on_compile)
        if self.histograms_enabled:
            self.hists = _hist.HistogramSet(
                slow_factor=(
                    float(fcfg.get("slow_span_factor", 8.0)) if self.flight is not None else 0.0
                ),
                slow_warmup=int(fcfg.get("slow_span_warmup", 64)),
                slow_min_s=float(fcfg.get("slow_span_min_ms", 100.0)) / 1e3,
                on_slow=self._on_slow_span if self.flight is not None else None,
            )
            _hist.install(self.hists)
        lcfg = dict(self.cfg.get("learn", {}) or {})
        if bool(lcfg.get("enabled", True)):
            from sheeprl_tpu_torch.obs import learn as _learn

            self.sentinel = _learn.LearnSentinel(
                lcfg, counters=self.counters, flight=self.flight, step_source=lambda: self.policy_steps
            )
            _learn.install(self.sentinel)
        guard_cfg = self.cfg.get("health", {}) or {}
        if bool(guard_cfg.get("nan_guard", True)):
            self.guard = NonFiniteGuard(
                prefixes=tuple(guard_cfg.get("nan_guard_prefixes", ("Loss/", "Grads/"))),
                raise_on_nonfinite=bool(guard_cfg.get("raise_on_nonfinite", False)),
                counters=self.counters,
                # terminal stage: the flight dump and the learn sentinel's
                # first non-finite timestamp (the acceptance ordering)
                on_fire=(
                    self._on_nonfinite if (self.flight is not None or self.sentinel is not None) else None
                ),
            )
            from sheeprl_tpu_torch.utils.metric import set_value_guard

            set_value_guard(self.guard)
        if self.trace_file:  # explicit path: trace from the very beginning
            self._open_tracer(self.trace_file)
        elif not self.trace_enabled and self.flight is not None:
            # no trace file wanted, but the flight recorder still needs the
            # event stream: run the writer file-less from the start
            self._open_tracer(None)

    def _open_tracer(self, path: Optional[str], process_name: Optional[str] = None) -> None:
        if self.tracer is not None:
            return
        file_path = path if self.trace_enabled else None
        if file_path is None and self.flight is None:
            return
        self.tracer = TraceWriter(
            file_path,
            xla_annotations=self.xla_annotations,
            ring=self.flight,
            pid=self._rank,
            process_name=process_name,
        )
        set_tracer(self.tracer)

    def attach_run_dir(self, log_dir: str) -> None:
        """Called once the versioned run directory exists (logger layer).

        Rank 0 owns the summary, the live exporter, and ``trace.jsonl``;
        other ranks write per-rank trace files (``trace_rank<k>.jsonl``,
        merged by ``tools.trace_view``) and dump their histograms at
        finalize for rank 0's cross-rank percentile merge."""
        if not log_dir or self.run_dir is not None:
            return
        self.run_dir = log_dir
        tel_dir = os.path.join(log_dir, "telemetry")
        if self.flight is not None:
            self.flight.attach_dir(
                tel_dir, tag="" if self._rank == 0 else f"_r{self._rank}"
            )
        if self._rank != 0:
            self._open_tracer(
                os.path.join(tel_dir, f"trace_rank{self._rank}.jsonl"),
                process_name=f"rank{self._rank}",
            )
            return
        if self.summary_path is None:
            self.summary_path = os.path.join(log_dir, "telemetry.json")
        self._open_tracer(os.path.join(tel_dir, "trace.jsonl"), process_name="learner")
        if self.live_interval_s > 0 or self.serve_port:
            self.live = LiveExporter(
                self._live_snapshot,
                os.path.join(tel_dir, "live.json"),
                interval_s=self.live_interval_s,
                window_s=self.live_window_s,
            )
            self.live.start()
            if self.serve_port is not None:
                try:
                    self.prom = PromServer(self.live, self.serve_port)
                    self.prom.start()
                except OSError as exc:
                    import warnings

                    warnings.warn(
                        f"telemetry: cannot serve metrics on port "
                        f"{self.serve_port}: {exc}"
                    )

    def watchdog(self, **kwargs) -> StallWatchdog:
        """A stall watchdog wired to this run's counters and timeout config.

        The telemetry stops it at finalize; callers still stop it eagerly
        when their threads exit so a finished run is not flagged. A stall
        additionally fires the flight recorder, so the evidence ring is
        dumped while the wedged thread is still wedged."""
        kwargs.setdefault("timeout_s", self.stall_timeout_s)
        user_on_stall = kwargs.pop("on_stall", None)
        flight = self.flight
        if flight is not None:

            def _on_stall(role: str, age_s: float) -> None:
                flight.trigger("stall", {"role": role, "age_s": round(age_s, 1)})
                if user_on_stall is not None:
                    user_on_stall(role, age_s)

            kwargs["on_stall"] = _on_stall
        elif user_on_stall is not None:
            kwargs["on_stall"] = user_on_stall
        dog = StallWatchdog(counters=self.counters, **kwargs)
        self._watchdogs.append(dog)
        return dog

    # -- flight-recorder triggers -------------------------------------------

    def _flight_context(self) -> Dict[str, Any]:
        return {
            "counters": self.counters.as_dict(),
            "phase_percentiles": self.hists.percentiles() if self.hists is not None else {},
        }

    def _on_slow_span(self, name: str, seconds: float, p50: float) -> None:
        self.flight.trigger(
            "slow_span",
            {
                "span": name,
                "duration_ms": round(seconds * 1e3, 3),
                "running_p50_ms": round(p50 * 1e3, 3),
            },
        )

    def _on_compile(self, duration_s: float) -> None:
        # cold-start captures are expected; only one made after warm-up (a
        # step rebuilt for a new shape mid-run) is an anomaly
        if time.perf_counter() - self._t_start < self._recompile_warmup_s:
            return
        self.flight.trigger("recompile", {"compile_s": round(duration_s, 3)})

    def _on_nonfinite(self, name: str, value: float) -> None:
        if self.flight is not None:
            self.flight.trigger("nonfinite", {"metric": name, "value": str(value)})
        if self.sentinel is not None:
            self.sentinel.on_nonfinite(name, value)

    def _live_snapshot(self) -> Dict[str, Any]:
        snap = self.summary()
        snap["watchdog_beat_age_s"] = {
            role: info
            for dog in self._watchdogs
            for role, info in dog.beat_ages().items()
        }
        # fold any source sidecars already on disk (exited players, closed
        # env pools, other ranks) into the live view too — live.json is the
        # same merged shape as the final telemetry.json. Staleness dumps are
        # NOT merged here (that exact merge runs once, at finalize — doing
        # it per live write would double-count).
        if self.run_dir:
            from sheeprl_tpu_torch.obs.dist import aggregate as _aggregate

            _aggregate.merge_into_summary(
                snap, os.path.join(self.run_dir, "telemetry"), None
            )
        return snap

    # -- run accounting -----------------------------------------------------

    def record_window(
        self,
        policy_steps: int = 0,
        train_steps: int = 0,
        env_seconds: float = 0.0,
        train_seconds: float = 0.0,
        stage_seconds: float = 0.0,
    ) -> None:
        self.policy_steps += int(policy_steps)
        self.train_steps += int(train_steps)
        self.env_seconds += float(env_seconds)
        self.train_seconds += float(train_seconds)
        self.stage_seconds += float(stage_seconds)

    def set_train_flops(self, flops_per_step: Optional[float]) -> None:
        """Register per-train-step-unit FLOPs (None records the attempt, so a
        backend without cost analysis is probed once, not every update)."""
        self._flops_attempted = True
        if flops_per_step:
            self.flops_per_train_step = float(flops_per_step)

    def set_train_cost(
        self,
        flops_per_step: Optional[float],
        bytes_per_step: Optional[float] = None,
        dispatches_per_step: int = 1,
    ) -> None:
        """Register the train program's full analytic cost (FLOPs + bytes
        accessed, per train-step unit) — ``obs.register_train_cost`` calls
        this; the bytes side feeds the roofline's bandwidth axis and
        ``dispatches_per_step`` is the step calls a train-step unit makes."""
        self.set_train_flops(flops_per_step)
        if bytes_per_step:
            self.bytes_per_train_step = float(bytes_per_step)
        self.dispatches_per_train_step = max(int(dispatches_per_step), 1)

    def record_prof(self, record: Dict[str, Any]) -> None:
        """Latest in-run profile result (StepProfiler / flight-recorder
        capture), folded into summary(), live.json and telemetry.json. A
        window that caught no train execution (``device_ms_per_step`` null)
        never replaces an earlier measured one, and a slow parse of an old
        capture landing out of order never replaces a newer measured one."""
        prev = self._prof_last
        if record.get("device_ms_per_step") is None and prev is not None:
            return
        if (
            prev is not None
            and prev.get("device_ms_per_step") is not None
            and isinstance(prev.get("step"), int)
            and isinstance(record.get("step"), int)
            and record["step"] < prev["step"]
        ):
            return
        self._prof_last = record

    def needs_train_flops(self) -> bool:
        """Should a train step count its FLOPs on its next eager call?"""
        return not self._flops_attempted and self.flops_per_train_step is None

    # -- summary ------------------------------------------------------------

    def summary(self) -> Dict[str, Any]:
        wall = time.perf_counter() - self._t_start
        # no windows were ever accounted (metric.log_level=0 disables the log
        # boundaries that feed record_window): report null, not a fake 0.0 —
        # the counters below are still exact
        accounted = self.policy_steps > 0 or self.train_steps > 0
        out: Dict[str, Any] = {
            "run_wall_s": round(wall, 3),
            "policy_steps": self.policy_steps if accounted else None,
            "train_steps": self.train_steps if accounted else None,
            "sps": round(self.policy_steps / wall, 3) if wall > 0 and accounted else None,
            "sps_env": (
                round(self.policy_steps / self.env_seconds, 3) if self.env_seconds else None
            ),
            "sps_train": (
                round(self.train_steps / self.train_seconds, 3) if self.train_seconds else None
            ),
            "mfu": mfu_pct(
                self.flops_per_train_step,
                self.train_steps,
                self.train_seconds,
                self.peak_tflops,
            ),
            "mfu_peak_tflops": self.peak_tflops,
            "flops_per_train_step": self.flops_per_train_step,
            "bytes_per_train_step": self.bytes_per_train_step,
            "env_seconds": round(self.env_seconds, 3),
            "train_seconds": round(self.train_seconds, 3),
            "stage_seconds": round(self.stage_seconds, 3),
        }
        out.update(self.counters.as_dict())
        out.update(
            self.poller.snapshot()
            if self.poller is not None
            else {"peak_hbm_bytes": 0, "hbm_bytes_limit": 0, "hbm_samples": 0}
        )
        out["phase_percentiles"] = (
            self.hists.percentiles() if self.hists is not None else {}
        )
        out["flight_dumps"] = self.flight.dumps if self.flight is not None else 0
        out["flight_suppressed"] = self.flight.suppressed if self.flight is not None else 0
        # in-run device profile (obs/prof): the latest capture's headline
        # numbers as first-class summary keys, the detail as a sub-dict
        p = self._prof_last
        out["device_ms_per_step"] = p.get("device_ms_per_step") if p else None
        out["mfu_device_pct"] = p.get("mfu_device_pct") if p else None
        out["roofline_verdict"] = p.get("roofline_verdict") if p else None
        out["prof_captures"] = self.prof.captures if self.prof is not None else 0
        if p is not None:
            out["prof"] = {
                k: p.get(k)
                for k in (
                    "step",
                    "source",
                    "train_module",
                    "train_execs",
                    "comms_ms_per_step",
                    "compute_ms_per_step",
                    "compute_dtype",
                    "compute_peak_tflops",
                    "compute_util_pct",
                    "achieved_gbps",
                    "bandwidth_util_pct",
                    "arithmetic_intensity",
                    "busy_frac",
                    "window_ms",
                    "trace_dir",
                    "kernel_counts",
                    "kernel_launches",
                    "events",
                    "costs_s",
                )
            }
            out["prof"]["peaks"] = (p.get("peaks") or {}).get("label")
            out["prof"]["failed"] = self.prof.failed if self.prof is not None else 0
        elif self.prof is not None and self.prof.failed:
            # every capture failed: the count and the reason, the headline numbers stay null
            out["prof"] = {"failed": self.prof.failed, "last_failure": self.prof.last_failure}
        # learning health (obs/learn): headline percentiles flat (Prometheus
        # exports scalars), the event/baseline detail as a sub-dict
        if self.sentinel is not None:
            out["grad_norm_p95"] = self.sentinel.quantile("learn/grad_norm", 0.95)
            out["update_ratio_p50"] = self.sentinel.quantile("learn/update_ratio", 0.50)
            out["learn"] = self.sentinel.summary()
        else:
            out["grad_norm_p95"] = None
            out["update_ratio_p50"] = None
        # distributed observability (obs/dist): data-staleness lineage plus
        # the per-source breakdown of every process feeding this run
        staleness = self.staleness.summary() if self.staleness is not None else None
        out["staleness"] = staleness
        age = (staleness or {}).get("sample_age_s") or {}
        lag = (staleness or {}).get("policy_lag_versions") or {}
        out["sample_age_p95_s"] = age.get("p95_s")
        out["policy_lag_p95"] = lag.get("p95_v")
        from sheeprl_tpu_torch.obs.dist import aggregate as _aggregate

        sources = _aggregate.source_snapshots()
        if sources:
            out["sources"] = sources
        if self.tracer is not None and self.tracer.path:
            out["trace_file"] = self.tracer.path
        return out

    def _sync_rank_hists(self) -> None:
        """Cross-rank percentile merge over the shared run dir: ranks > 0
        dump their histograms at finalize, rank 0 merges whatever dumps have
        landed (best-effort — a rank finalizing after rank 0 is missed, the
        dumps stay on disk for offline merging via ``obs.hist``)."""
        if self.hists is None or not self.run_dir:
            return
        tel_dir = os.path.join(self.run_dir, "telemetry")
        if self._rank != 0:
            try:
                atomic_write_json(
                    os.path.join(tel_dir, f"hist_rank{self._rank}.json"),
                    self.hists.to_dict(),
                )
            except OSError:
                pass
            return
        import glob

        for path in sorted(glob.glob(os.path.join(tel_dir, "hist_rank*.json"))):
            try:
                with open(path) as f:
                    self.hists.merge_dict(json.load(f))
            except Exception:
                pass  # a torn/foreign dump must not break finalize

    def _merge_sources(self, summary: Dict[str, Any]) -> None:
        """Cross-process telemetry merge (obs/dist/aggregate): ranks > 0
        dump a full summary sidecar; rank 0 folds every sidecar (ranks,
        plane players, env pools) plus the live source registry into this
        run's final summary — ONE merged ``telemetry.json`` with summed
        rank counters, merged staleness percentiles, and a per-source
        breakdown under ``sources``."""
        from sheeprl_tpu_torch.obs.dist import aggregate as _aggregate

        tel_dir = os.path.join(self.run_dir, "telemetry") if self.run_dir else None
        if self._rank != 0:
            if tel_dir is not None:
                sidecar = dict(summary)
                if self.staleness is not None:
                    sidecar["staleness_dump"] = self.staleness.to_dict()
                _aggregate.write_sidecar(tel_dir, f"rank{self._rank}", sidecar)
            return
        _aggregate.merge_into_summary(summary, tel_dir, self.staleness)
        if self.staleness is not None:
            # rank staleness dumps merged above — refresh the percentiles
            staleness = self.staleness.summary()
            summary["staleness"] = staleness
            age = (staleness or {}).get("sample_age_s") or {}
            lag = (staleness or {}).get("policy_lag_versions") or {}
            summary["sample_age_p95_s"] = age.get("p95_s")
            summary["policy_lag_p95"] = lag.get("p95_v")

    def finalize(
        self, print_summary: bool = True, error: Optional[BaseException] = None
    ) -> Optional[Dict[str, Any]]:
        if self._finalized:
            return None
        self._finalized = True
        if self.prof is not None:
            self.prof.close()  # an open capture still lands its numbers
        from sheeprl_tpu_torch.obs.prof import capture as _capture

        _capture.set_loop_thread(None)
        if self.flight is not None:
            self.flight.close_capture()
        for dog in self._watchdogs:
            dog.stop()
        if self.prom is not None:
            self.prom.stop()
        if self.live is not None:
            self.live.stop()  # writes the final live.json
        if self.poller is not None:
            self.poller.stop()
        if self.guard is not None:
            from sheeprl_tpu_torch.utils.metric import set_value_guard

            set_value_guard(None)
        _counters.set_compile_hook(None)
        self._sync_rank_hists()
        summary = self.summary()
        self._merge_sources(summary)
        summary["crashed"] = error is not None
        if error is not None:
            summary["exception"] = f"{type(error).__name__}: {error}"[:300]
        if self.tracer is not None:
            set_tracer(None)
            self.tracer.close()
        _counters.install(None)
        _hist.install(None)
        if self.sentinel is not None:
            from sheeprl_tpu_torch.obs import learn as _learn

            if _learn.installed() is self.sentinel:
                _learn.install(None)
        from sheeprl_tpu_torch.obs.dist import staleness as _staleness

        if _staleness.installed() is self.staleness:
            _staleness.install(None)
        if self.summary_enabled and self.summary_path and self._rank == 0:
            os.makedirs(os.path.dirname(os.path.abspath(self.summary_path)), exist_ok=True)
            with open(self.summary_path, "w") as f:
                json.dump(summary, f, indent=2, sort_keys=True)
                f.write("\n")
        if print_summary:
            self._print(summary)
        return summary

    def _print(self, s: Dict[str, Any]) -> None:
        if self._rank != 0:
            return

        def fmt_bytes(n):
            if not n:
                return "0 B"
            for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
                if abs(n) < 1024 or unit == "TiB":
                    return f"{n:.1f} {unit}" if unit != "B" else f"{n} B"
                n /= 1024

        steps = (
            f"policy steps {s['policy_steps']} (sps {s['sps']}) · "
            f"train steps {s['train_steps']}"
            + (f" (sps_train {s['sps_train']})" if s["sps_train"] else "")
            if s["policy_steps"] is not None
            else "steps not accounted (metric.log_level=0)"
        )
        lines = [
            "── run telemetry "
            + "─" * 46,
            f"  wall {s['run_wall_s']:.1f}s · " + steps,
            f"  staged h2d {fmt_bytes(s['bytes_staged_h2d'])} over "
            f"{s['h2d_transfers']} transfers · graph captures {s['recompiles']} "
            f"({s['compile_secs']}s) · replays {s['graph_replays']} · "
            f"{s['compile_cache_hits']} kernel cache hits",
            f"  peak HBM {fmt_bytes(s['peak_hbm_bytes'])}"
            + (f" / {fmt_bytes(s['hbm_bytes_limit'])}" if s["hbm_bytes_limit"] else "")
            + (f" · MFU {s['mfu']}%" if s["mfu"] is not None else "")
            + f" · non-finite {s['nonfinite_metrics']} · stalls {s['stalls']}",
        ]
        if s.get("device_ms_per_step") is not None:
            lines.append(
                f"  device {s['device_ms_per_step']} ms/step"
                + (
                    f" · MFU(dev) {s['mfu_device_pct']}%"
                    if s.get("mfu_device_pct") is not None
                    else ""
                )
                + f" · {s.get('roofline_verdict')}"
            )
        if s.get("env_steps_async") or s.get("env_worker_restarts"):
            lines.append(
                f"  async envs: {s['env_steps_async']} steps · "
                f"{s['env_worker_restarts']} worker restart(s)"
                + (" · DEGRADED TO SYNC" if s.get("env_degraded_to_sync") else "")
            )
        if s.get("comms_ops"):
            best = max(
                (k.get("best_gbps") or 0.0 for k in (s.get("comms") or {}).values()),
                default=0.0,
            )
            lines.append(
                f"  comms: {s['comms_ops']} collective(s) · "
                f"{fmt_bytes(s['comms_bytes'])} payload · {s['comms_ms']:.1f} ms"
                + (f" · best {best:.2f} GB/s wire" if best else "")
            )
        stale = s.get("staleness") or {}
        if stale.get("sample_age_s") or stale.get("policy_lag_versions"):
            age = stale.get("sample_age_s") or {}
            lag = stale.get("policy_lag_versions") or {}
            bits = []
            if age.get("p95_s") is not None:
                bits.append(f"sample age p50/p95 {age['p50_s']:.2f}/{age['p95_s']:.2f} s")
            if lag.get("p95_v") is not None:
                bits.append(f"policy lag p95 {lag['p95_v']:.1f} version(s)")
            lines.append("  staleness: " + " · ".join(bits))
        if s.get("sources"):
            lines.append(
                f"  sources merged: {', '.join(sorted(s['sources']))}"
            )
        if s.get("plane_traj_slabs") or s.get("plane_player_restarts"):
            lines.append(
                f"  plane: {s['plane_traj_slabs']} trajectory slab(s) · "
                f"policy v{s['plane_policy_version']} · "
                f"{s['plane_player_restarts']} player restart(s)"
            )
        if s["ckpt_saves"] or s["ckpt_failures"]:
            lines.append(
                f"  ckpt {s['ckpt_saves']} saves ({fmt_bytes(s['ckpt_bytes'])}), "
                f"step path blocked {s['ckpt_blocked_ms']:.0f} ms of "
                f"{s['ckpt_write_ms']:.0f} ms write time"
                + (f" · {s['ckpt_failures']} FAILED" if s["ckpt_failures"] else "")
            )
        tails = []
        for name, label in (
            ("Time/train_time", "train"),
            ("Time/env_interaction_time", "env"),
            ("Time/stage_h2d_time", "stage"),
            ("Time/plane_wait_time", "plane_wait"),
        ):
            pct = s.get("phase_percentiles", {}).get(name)
            if pct and pct.get("p95_ms") is not None:
                tails.append(f"{label} p50/p95 {pct['p50_ms']:.0f}/{pct['p95_ms']:.0f} ms")
        if tails:
            lines.append("  tails: " + " · ".join(tails))
        if s.get("learn_warnings") or s.get("learn_criticals"):
            lines.append(
                f"  learning health: {s.get('learn_warnings', 0)} warning(s) · "
                f"{s.get('learn_criticals', 0)} CRITICAL"
                + (
                    f" · grad_norm p95 {s['grad_norm_p95']:.3g}"
                    if s.get("grad_norm_p95") is not None
                    else ""
                )
            )
        if s.get("crashed"):
            lines.append(f"  CRASHED: {s.get('exception', '?')}")
        if s.get("flight_dumps"):
            lines.append(f"  flight recorder fired {s['flight_dumps']} time(s)")
        if self.summary_enabled and self.summary_path:
            lines.append(f"  written to {self.summary_path}")
        if "trace_file" in s:
            lines.append(f"  trace: {s['trace_file']}")
        lines.append("─" * 63)
        print("\n".join(lines), flush=True)


def setup_telemetry(cfg, device: Any = None, rank: int = 0) -> Optional[Telemetry]:
    """Build and activate telemetry from a composed run config (or return
    None when ``metric.telemetry.enabled`` is off/absent) for a run on
    ``device`` at process rank ``rank``."""
    global _ACTIVE
    tcfg = {}
    try:
        tcfg = dict(cfg.metric.get("telemetry", {}) or {})
    except AttributeError:
        pass
    if not tcfg.get("enabled", False):
        _ACTIVE = None
        return None
    telemetry = Telemetry(tcfg, device=device, rank=rank)
    # the run's fabric.precision: the roofline verdict weighs a capture's FLOP rate against its compute type's peak
    try:
        telemetry.precision = str(cfg.fabric.precision)
    except AttributeError:
        pass
    telemetry.start()
    _ACTIVE = telemetry
    return telemetry


def finalize_telemetry(
    print_summary: bool = True, error: Optional[BaseException] = None
) -> Optional[Dict[str, Any]]:
    """Finalize and deactivate the run telemetry (idempotent). ``error`` is
    the exception that ended the run (if any) — the summary then records
    ``"crashed": true`` plus the exception type alongside the partial
    counters, so a dead run's last telemetry is still evidence."""
    global _ACTIVE
    telemetry, _ACTIVE = _ACTIVE, None
    if telemetry is None:
        return None
    return telemetry.finalize(print_summary=print_summary, error=error)

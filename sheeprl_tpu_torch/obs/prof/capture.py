"""In-run device-profile capture: scheduled windows, parsed off the loop's
thread and folded into the run telemetry (counterpart of
``sheeprl_tpu/obs/prof/capture.py``).

Every ``metric.telemetry.profile.every_n_steps`` policy steps (default off)
the :class:`StepProfiler` opens a ``torch.profiler`` window (CPU and, with a
card, CUDA activities) at a log boundary, closes it after
``profile.window_s`` seconds (so a slow log cadence cannot produce a
gigabyte trace), writes the Chrome trace to
``telemetry/prof/step_<n>/trace.json``, attributes its device time
(:mod:`~sheeprl_tpu_torch.obs.prof.trace`), runs the roofline against the
registered train cost and folds ``device_ms_per_step`` / ``mfu_device_pct``
/ ``roofline_verdict`` into ``telemetry.json`` and ``live.json`` (and
``telemetry/prof/capture_<step>.json``).

Entrypoints drive it through one call, :func:`profile_tick`, at the log
boundary beside ``log_sps_metrics`` (``tests/test_torch_lint_telemetry.py``
holds the pairing). Everything is a no-op when telemetry or the profile
group is off, and a failed capture or parse never takes a run down.

**Threads.** A ``torch.profiler`` session records the host operations of
the thread that started it and can only be stopped on that thread (stopping
it on another finds no session there). So a window is owned by the thread
that opened it: its ``window_s`` deadline is checked on that thread, at
every span's exit (:func:`poll`, one flag read outside a window) and at the
next tick, and whichever comes first stops it, exactly once. The device
activity (CUPTI) is recorded from every thread. The flight recorder's
anomaly window (``flight.profiler_capture_s``) is opened the same way: a
trigger on another thread queues it for the loop thread's next span.

One profiler session per process: the :class:`StepProfiler`, the flight
recorder and ``metric.profiler``'s whole-run trace arbitrate through
:func:`try_begin_capture` / :func:`end_capture`.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

__all__ = [
    "CaptureWindow",
    "NoDeviceEvents",
    "StepProfiler",
    "analyze_trace",
    "end_capture",
    "open_window",
    "parse_and_fold",
    "poll",
    "profile_tick",
    "queue_window",
    "try_begin_capture",
    "whole_run_trace",
]

# one torch.profiler session per process: shared by the StepProfiler, the
# flight recorder's anomaly window and metric.profiler's whole-run trace
_CAPTURE_LOCK = threading.Lock()
_CAPTURE_ACTIVE = False

#: the open window (None outside one) and the windows queued for the loop thread
_WINDOW: Optional["CaptureWindow"] = None
_QUEUED: List[Callable[[], None]] = []
#: the thread that opens queued windows (the training loop's: set by the telemetry)
_LOOP_THREAD: Optional[int] = None


def try_begin_capture() -> bool:
    """Claim the process-wide profiler slot; False when a capture is live."""
    global _CAPTURE_ACTIVE
    with _CAPTURE_LOCK:
        if _CAPTURE_ACTIVE:
            return False
        _CAPTURE_ACTIVE = True
        return True


def end_capture() -> None:
    global _CAPTURE_ACTIVE
    with _CAPTURE_LOCK:
        _CAPTURE_ACTIVE = False


def set_loop_thread(ident: Optional[int]) -> None:
    """The thread whose spans open queued windows (None: no thread does)."""
    global _LOOP_THREAD
    _LOOP_THREAD = ident
    if ident is None:
        with _CAPTURE_LOCK:
            _QUEUED.clear()


def _launch_counts() -> Dict[str, int]:
    """The port's kernel launch counters, if the kernels are loaded (no import)."""
    ops = sys.modules.get("sheeprl_tpu_torch.kernels.ops")
    if ops is None:
        return {}
    return {c.name: int(c.count) for c in getattr(ops, "_COUNTERS", ())}


def _drain() -> None:
    """Wait for the card's queued work, where CUDA is in use."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def profiler_activities() -> list:
    """CPU, and CUDA where a card is visible."""
    import torch
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])


class _Session:
    """A ``torch.profiler`` session that records, besides the card's
    activity (kernels, copies, the runtime calls that launched them), only
    the user's ranges (``record_function``: the steps and spans), not every
    operator: a window over a few DreamerV3 steps (~16,000 kernels each) then
    stops, writes and parses in seconds, not minutes. ``stop()`` returns the
    session's results (``.events()``, ``.save(path)``)."""

    def __init__(self):
        import torch
        from torch._C._profiler import RecordScope

        kineto = torch.profiler.profile(activities=profiler_activities())
        kineto.prepare_trace()
        self._autograd = kineto.profiler
        torch.autograd._enable_profiler(self._autograd.config(), self._autograd.kineto_activities,
                                        {RecordScope.USER_SCOPE})

    @staticmethod
    def stop():
        import torch

        return torch.autograd._disable_profiler()


class CaptureWindow:
    """One ``torch.profiler`` session, owned by the thread that opened it.

    ``stop()`` runs on the owner thread, exactly once; then the trace is
    written to ``<out_dir>/trace.json`` and read on a thread of its own,
    which calls ``on_done(events_or_None, window)`` (the parse). ``launches``
    holds the port's kernel-launch counter deltas over the window."""

    def __init__(self, out_dir: str, seconds: float, on_done: Optional[Callable] = None):
        self.out_dir = out_dir
        self.seconds = float(seconds or 0.0)
        self.on_done = on_done
        self.owner = threading.get_ident()
        self.deadline: Optional[float] = None
        self.prof = None
        self.stopped = False
        self.launches: Dict[str, int] = {}
        #: the window's own cost, host seconds: stopping the session, reading its events, writing the trace, parsing
        self.costs_s: Dict[str, float] = {}
        self.done = threading.Event()
        self.parse_thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._launches0: Dict[str, int] = {}

    def start(self) -> bool:
        """Start the session on this thread (the slot must be claimed). The
        card's queue is drained first and again at the stop, so that the
        window holds the device work of exactly the launches made inside it
        (the kernel counters' delta counts those)."""
        try:
            _drain()
            self._launches0 = _launch_counts()
            self.prof = _Session()
        except Exception:
            self.prof = None
            return False
        if self.seconds > 0:
            self.deadline = time.perf_counter() + self.seconds
        return True

    def due(self) -> bool:
        return self.deadline is not None and time.perf_counter() >= self.deadline

    def stop(self) -> bool:
        """Stop the session (on the owner thread; once) and release the slot;
        the write and the parse go to a thread of their own. True when this
        call stopped it."""
        global _WINDOW
        with self._lock:
            if self.stopped or threading.get_ident() != self.owner:
                return False
            self.stopped = True
        try:
            _drain()
            t0 = time.perf_counter()
            self.prof = self.prof.stop()
            self.costs_s["stop"] = time.perf_counter() - t0
            after = _launch_counts()
            self.launches = {k: after.get(k, 0) - v for k, v in self._launches0.items()}
        except Exception:
            self.prof = None
        if _WINDOW is self:
            _WINDOW = None
        end_capture()
        self.parse_thread = threading.Thread(target=self._write_and_parse, name="obs-prof-parse", daemon=True)
        self.parse_thread.start()
        return True

    def _write_and_parse(self) -> None:
        record = None
        events = None
        try:
            if self.prof is not None:
                from sheeprl_tpu_torch.obs.prof.trace import events_from_profiler

                os.makedirs(self.out_dir, exist_ok=True)
                t0 = time.perf_counter()
                events = events_from_profiler(self.prof)
                t1 = time.perf_counter()
                self.prof.save(os.path.join(self.out_dir, "trace.json"))
                self.costs_s.update(read=t1 - t0, write=time.perf_counter() - t1)
        except Exception:
            pass
        try:
            if self.on_done is not None:
                record = self.on_done(events, self)
        finally:
            self.prof = None
            self.done.set()
        return record

    def wait(self, timeout: float = 120.0) -> None:
        """Join the write and the parse."""
        if self.parse_thread is not None:
            self.parse_thread.join(timeout=timeout)


def open_window(out_dir: str, seconds: float, on_done: Optional[Callable] = None) -> Optional[CaptureWindow]:
    """Open a window on this thread, or None when the slot is taken or the
    profiler cannot start. ``seconds`` > 0 bounds it (:func:`poll`)."""
    global _WINDOW
    if not try_begin_capture():
        return None
    window = CaptureWindow(out_dir, seconds, on_done)
    if not window.start():
        end_capture()
        return None
    _WINDOW = window
    return window


def queue_window(opener: Callable[[], None]) -> bool:
    """Run ``opener`` now on the loop thread, else at the loop thread's next
    :func:`poll` (a profiler session must start on the thread that stops
    it). False when no loop thread is set (nothing will run it)."""
    if _LOOP_THREAD is None:
        return False
    if threading.get_ident() == _LOOP_THREAD:
        opener()
        return True
    with _CAPTURE_LOCK:
        _QUEUED.append(opener)
    return True


def poll() -> None:
    """Close the open window once its deadline passed (on its own thread)
    and open queued windows (on the loop thread). Spans call this on exit."""
    window = _WINDOW
    if window is not None and window.due() and threading.get_ident() == window.owner:
        window.stop()
    if _QUEUED and threading.get_ident() == _LOOP_THREAD:
        with _CAPTURE_LOCK:
            queued = list(_QUEUED)
            _QUEUED.clear()
        for opener in queued:
            opener()


@contextlib.contextmanager
def whole_run_trace(trace_dir: str) -> Iterator[None]:
    """``metric.profiler``: one ``torch.profiler`` session around the whole
    block, its Chrome trace written to ``<trace_dir>/trace.json`` at the end.
    It holds the profiler slot, so no scheduled or anomaly window opens
    inside it."""
    import torch

    if not try_begin_capture():
        raise RuntimeError("metric.profiler: another profiler session is live in this process")
    try:
        with torch.profiler.profile(activities=profiler_activities()) as prof:
            yield
    finally:
        end_capture()
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


class NoDeviceEvents(RuntimeError):
    """A capture on a card whose trace holds no device event."""


def analyze_trace(
    trace: Any,
    flops_per_step: Optional[float] = None,
    bytes_per_step: Optional[float] = None,
    world_size: int = 1,
    dispatches_per_step: int = 1,
    peaks: Optional[Dict[str, Any]] = None,
    device: Any = None,
    compute_dtype: Optional[str] = None,
) -> Dict[str, Any]:
    """Attribute one capture (a trace directory or file, or its normalized
    events) and run the roofline on its train module.

    The host fallback (the step ranges' host time where the trace holds no
    device event) is a CPU run's profile only: for a ``device`` on a card a
    window without device events is a failed capture
    (:class:`NoDeviceEvents`), never host milliseconds read as device time.
    ``compute_dtype`` (``bf16``, ``tf32``, ``f32``: ``roofline.compute_dtype``)
    picks the peak the verdict weighs the FLOP rate against; the MFU stays
    against the bf16 peak.

    ``flops_per_step`` / ``bytes_per_step`` are per train-step *unit* (the
    ``set_train_cost`` convention: a step call's cost × dispatches_per_step /
    world_size, the step counter advancing by world_size per training
    block), so a call's cost is ``× world_size / dispatches_per_step`` and
    per-unit device time is ``× dispatches_per_step / world_size``. The
    train module's time a call is its replays' mean where it replayed a
    CUDA graph in the window, else its executions' mean."""
    from sheeprl_tpu_torch.obs.prof.roofline import compute_peak, detect_peaks, roofline_analyze
    from sheeprl_tpu_torch.obs.prof.trace import find_trace, load_trace, summarize_events

    summary = summarize_events(trace if isinstance(trace, list) else load_trace(find_trace(trace)))
    if summary["source"] != "device" and str(device or "cpu").startswith("cuda"):
        raise NoDeviceEvents(
            f"the window on {device} holds no device event (source {summary['source']!r}): "
            "the profiler recorded no CUDA activity"
        )
    train = summary["train_module"]
    rec = summary["modules"].get(train) if train else None
    # a step replayed from a CUDA graph is timed over its replays (its eager warm-up calls are not the steady state)
    ms_per_exec = (rec.get("ms_per_replay") or rec["ms_per_exec"]) if rec else None
    ws = max(int(world_size), 1)
    dps = max(int(dispatches_per_step), 1)
    peaks = peaks or detect_peaks(device=device)
    roofline = roofline_analyze(
        flops_per_exec=flops_per_step * ws / dps if flops_per_step else None,
        bytes_per_exec=bytes_per_step * ws / dps if bytes_per_step else None,
        device_ms_per_exec=ms_per_exec,
        busy_frac=summary["busy_frac"],
        peaks=peaks,
        compute_peak_tflops=compute_peak(peaks, compute_dtype),
    )
    top = sorted(summary["modules"].items(), key=lambda kv: kv[1]["total_ms"], reverse=True)[:8]
    device_ms = round(ms_per_exec * dps / ws, 3) if ms_per_exec is not None else None
    # the compute-vs-comms split: the port runs no collective yet, so a device
    # trace's comms time is 0 and all of a step's device time is compute
    comms_total = summary.get("comms_ms_total")
    comms_ms = compute_ms = comms_by_kind = None
    if device_ms is not None and comms_total is not None and rec and rec["execs"]:
        comms_ms = round(comms_total / rec["execs"] * dps / ws, 4)
        compute_ms = round(max(device_ms - comms_ms, 0.0), 4)
        comms_by_kind = {
            kind: round(v / rec["execs"] * dps / ws, 4) for kind, v in (summary.get("comms_ms_by_kind") or {}).items()
        }
    return {
        "trace_dir": trace if isinstance(trace, str) else None,
        "source": summary["source"],
        "train_module": train,
        "train_execs": rec["execs"] if rec else 0,
        "device_ms_per_step": device_ms,
        "comms_ms_per_step": comms_ms,
        "comms_ms_by_kind_per_step": comms_by_kind,
        "compute_ms_per_step": compute_ms,
        "mfu_device_pct": roofline["mfu_pct"],
        "compute_dtype": compute_dtype or "bf16",
        "compute_peak_tflops": roofline["compute_peak_tflops"],
        "compute_util_pct": roofline["compute_util_pct"],
        "achieved_gbps": roofline["achieved_gbps"],
        "bandwidth_util_pct": roofline["bandwidth_util_pct"],
        "arithmetic_intensity": roofline["arithmetic_intensity"],
        "roofline_verdict": roofline["verdict"],
        "peaks": roofline["peaks"],
        "window_ms": summary["window_ms"],
        "busy_frac": summary["busy_frac"],
        "kernel_counts": summary.get("kernel_counts") or {},
        # the window's 30 costliest device operations, ms of self time in all
        "top_ops": {name: round(ms, 4) for name, ms in (summary.get("top_ops") or {}).items()},
        "modules": {
            name: {
                "phase": m["phase"],
                "execs": m["execs"],
                "ms_per_exec": round(m["ms_per_exec"], 3),
                "total_ms": round(m["total_ms"], 3),
                "replays": m.get("replays", 0),
                "ms_per_replay": round(m["ms_per_replay"], 3) if m.get("ms_per_replay") else None,
            }
            for name, m in top
        },
    }


def parse_and_fold(trace: Any, telemetry=None, world_size: Optional[int] = None) -> Optional[Dict[str, Any]]:
    """Best-effort: analyze a finished capture and fold it into
    ``telemetry``. Returns the record, or None when the trace is unreadable
    or, on a card, holds no device event (the reason in the StepProfiler's
    ``last_failure``).

    World size and peak overrides come from the telemetry when not given
    (``profile_tick`` records the caller's world size, the StepProfiler
    carries the ``profile.peak_*`` config), so an anomaly capture scales and
    classifies as a scheduled one does."""
    prof = getattr(telemetry, "prof", None)
    device = getattr(telemetry, "device", None)
    try:
        from sheeprl_tpu_torch.obs.prof.roofline import compute_dtype, detect_peaks

        record = analyze_trace(
            trace,
            flops_per_step=getattr(telemetry, "flops_per_train_step", None),
            bytes_per_step=getattr(telemetry, "bytes_per_train_step", None),
            world_size=world_size or getattr(telemetry, "last_world_size", 1),
            dispatches_per_step=getattr(telemetry, "dispatches_per_train_step", 1),
            peaks=detect_peaks(
                getattr(prof, "peak_tflops", None), getattr(prof, "peak_gbps", None), device=device,
            ),
            device=device,
            compute_dtype=compute_dtype(getattr(telemetry, "precision", None)),
        )
    except Exception as exc:
        if prof is not None:
            prof.last_failure = f"{type(exc).__name__}: {exc}"[:300]
        return None
    if telemetry is not None:
        telemetry.record_prof(record)
    return record


class StepProfiler:
    """Scheduled in-run capture windows, parsed and folded as they land.

    One capture at a time: ``tick`` opens a window when ``policy_step``
    crosses the next schedule point; the window closes at its
    ``window_s`` deadline (:func:`poll`) or at the next ``tick``, whichever
    comes first, and its trace is then written, parsed and folded on a
    thread of its own. A short run that never reaches another boundary is
    finalized by :meth:`close` from ``Telemetry.finalize``, so a profiled run
    always lands its numbers."""

    def __init__(self, pcfg: Dict[str, Any], telemetry):
        pcfg = dict(pcfg or {})
        self.every_n_steps = int(pcfg.get("every_n_steps", 0) or 0)
        ws = pcfg.get("window_s", 10.0)
        #: 0/null = no deadline: the window runs to the next log boundary
        self.window_s = float(ws) if ws else 0.0
        mc = pcfg.get("max_captures", 4)
        self.max_captures = int(mc) if mc is not None else 4
        self.peak_tflops = pcfg.get("peak_tflops") or None
        self.peak_gbps = pcfg.get("peak_gbps") or None
        self.enabled = self.every_n_steps > 0
        self.telemetry = telemetry
        self.captures = 0
        self.failed = 0
        #: why the newest failed capture failed (a parse error, no device event on a card)
        self.last_failure: Optional[str] = None
        self.last: Optional[Dict[str, Any]] = None
        self._next_at = self.every_n_steps
        self._lock = threading.Lock()
        self._active: Optional[CaptureWindow] = None
        self._windows: List[CaptureWindow] = []

    # -- the entrypoint hook --------------------------------------------------

    def tick(self, policy_step: int, world_size: int = 1) -> None:
        if not self.enabled:
            return
        if self._active is not None:
            self._finalize()
            return
        # failed attempts count toward the cap too: a persistently
        # unparseable trace must not re-open profiler windows all run long
        if policy_step >= self._next_at and self.captures + self.failed < self.max_captures:
            self._start(policy_step, world_size)
            # schedule strictly forward even if boundaries lag the cadence
            while self._next_at <= policy_step:
                self._next_at += self.every_n_steps

    def _start(self, policy_step: int, world_size: int) -> None:
        run_dir = getattr(self.telemetry, "run_dir", None)
        if run_dir is None:
            return
        out_dir = os.path.join(run_dir, "telemetry", "prof", f"step_{policy_step}")
        step, ws = int(policy_step), max(int(world_size), 1)

        def on_done(events, window: CaptureWindow) -> Optional[Dict[str, Any]]:
            t0 = time.perf_counter()
            record = parse_and_fold(events, self.telemetry, world_size=ws) if events else None
            window.costs_s["parse"] = time.perf_counter() - t0
            with self._lock:
                if record is None:
                    self.failed += 1
                    return None
                record["step"] = step
                record["trace_dir"] = out_dir
                record["kernel_launches"] = dict(window.launches)
                record["events"] = len(events)
                record["costs_s"] = dict(window.costs_s)
                self.captures += 1
                self.last = record
            try:
                from sheeprl_tpu_torch.obs.live import atomic_write_json

                atomic_write_json(os.path.join(os.path.dirname(out_dir), f"capture_{step}.json"), record)
            except OSError:
                pass  # a full disk must not take the run down
            return record

        window = open_window(out_dir, self.window_s, on_done)
        if window is not None:
            self._active = window
            self._windows.append(window)

    def _finalize(self, wait: bool = False) -> None:
        window, self._active = self._active, None
        if window is None:
            return
        window.stop()  # a no-op if the deadline stopped it already
        if wait:
            window.wait()

    def close(self) -> None:
        """Finalize any open window and join every parse (Telemetry.finalize
        calls this before assembling the summary: a slow earlier parse lands
        its numbers too)."""
        self._finalize(wait=True)
        for window in self._windows:
            window.wait()


def profile_tick(*, policy_step: int, world_size: int = 1) -> None:
    """The per-entrypoint profiling hook: advance the in-run capture
    scheduler. Call at the log boundary beside ``log_sps_metrics``; a no-op
    unless ``metric.telemetry.profile.every_n_steps`` is set."""
    from sheeprl_tpu_torch.obs.telemetry import get_telemetry

    telemetry = get_telemetry()
    if telemetry is None:
        return
    # remembered so an anomaly (flight-recorder) capture parsed outside any
    # tick scales per-unit numbers with the run's real world size
    telemetry.last_world_size = max(int(world_size), 1)
    poll()
    prof = getattr(telemetry, "prof", None)
    if prof is not None:
        prof.tick(policy_step, world_size)

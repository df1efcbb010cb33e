"""Phase spans: structured tracing layered on the wall-clock timer registry
(counterpart of ``sheeprl_tpu/obs/spans.py``, the same event schema).

:class:`span` is a drop-in superset of :class:`sheeprl_tpu_torch.utils.timer.timer`:
it accumulates wall seconds into the same global registry (so the
``Time/sps_*`` rate gauges keep working unchanged), and, when a run tracer is
active, additionally

- emits one Chrome trace-event per scope into a per-run JSONL file
  (``<log_dir>/telemetry/trace.jsonl``), and
- while a ``torch.profiler`` session is recording, mirrors the scope into
  ``torch.profiler.record_function`` (the ``xla_annotations`` key of the
  config: the JAX package mirrors into ``jax.profiler.TraceAnnotation``), so
  the same phase names show up in a profiler trace. Outside a profiler
  session the mirror costs one flag read.

A span's exit is also where an in-run profiler window is closed at its
deadline and a queued one opened (``obs/prof/capture.poll``: a
``torch.profiler`` session is stopped on the thread that started it).

A span is host wall time: it never synchronises the device. With no tracer
and no histogram set installed a ``span`` is exactly a ``timer`` (no file
handles, no clock read of its own).

Trace-event schema (one JSON object per line; the "complete event" subset of
the Chrome trace-event format):

``{"name": str, "cat": phase, "ph": "X", "ts": µs, "dur": µs,
  "pid": the fabric's process rank, "tid": host thread id}``

plus ``{"ph": "M", ...}`` thread-name and ``clock_sync`` metadata and
``{"ph": "C", ...}`` counter samples from the device poller.
``sheeprl_tpu_torch/tools/trace_view.py`` merges a run's files into one Perfetto trace.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from contextlib import ContextDecorator
from typing import Any, Dict, Optional

from sheeprl_tpu_torch.obs import hist as _hist
from sheeprl_tpu_torch.obs.prof import capture as _capture
from sheeprl_tpu_torch.utils.timer import timer

__all__ = ["span", "TraceWriter", "get_tracer", "set_tracer"]

#: events buffered before a file flush (bounds write syscalls in hot loops)
_FLUSH_EVERY = 128

_TRACER: Optional["TraceWriter"] = None


def get_tracer() -> Optional["TraceWriter"]:
    """The run's active tracer, or None (telemetry disabled)."""
    return _TRACER


def set_tracer(tracer: Optional["TraceWriter"]) -> None:
    global _TRACER
    _TRACER = tracer


def _profiler_recording() -> bool:
    """A ``torch.profiler`` session is recording in this process (torch is
    never imported for the question)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return False
    try:
        return bool(torch.autograd._profiler_enabled())
    except Exception:
        return False


class TraceWriter:
    """Thread-safe buffered Chrome trace-event JSONL writer.

    ``path=None`` runs the writer file-less: events are still produced (and
    fed to ``ring``, the flight recorder's bounded buffer) but nothing
    touches the disk. That is how a run with ``metric.telemetry.trace=false``
    keeps its flight recorder armed.
    """

    def __init__(
        self,
        path: Optional[str] = None,
        xla_annotations: bool = True,
        ring=None,
        pid: int = 0,
        process_name: Optional[str] = None,
        origin: Optional[float] = None,
    ):
        self.path = path
        self.xla_annotations = bool(xla_annotations)
        self.ring = ring
        if path is not None:
            os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
            self._file = open(path, "w")
        else:
            self._file = None
        self._lock = threading.Lock()
        self._buffer: list[str] = []
        self._origin = float(origin) if origin is not None else time.perf_counter()
        self._named_threads: set[int] = set()
        # plane players and env workers pass their own track id, so that
        # they do not collide with the learner's pid 0 in a merged view
        self._pid = int(pid)
        # wall-clock anchor so tools.trace_view can align files written
        # by processes with different perf_counter origins
        self._emit({"ph": "M", "name": "clock_sync", "pid": self._pid, "args": {"unix_ts": time.time()}})
        if process_name:
            self._emit({"ph": "M", "name": "process_name", "pid": self._pid, "args": {"name": process_name}})

    # -- time ---------------------------------------------------------------

    def now(self) -> float:
        """Monotonic seconds; pass to :meth:`complete` as the span start."""
        return time.perf_counter()

    def _us(self, t: float) -> float:
        return (t - self._origin) * 1e6

    # -- events -------------------------------------------------------------

    def _emit(self, event: Dict[str, Any]) -> None:
        if self.ring is not None:
            self.ring.record(event)
        if self._file is None:
            return
        line = json.dumps(event)
        with self._lock:
            self._buffer.append(line)
            if len(self._buffer) >= _FLUSH_EVERY:
                self._flush_locked()

    def _thread_meta(self, tid: int) -> None:
        if tid in self._named_threads:
            return
        self._named_threads.add(tid)
        self._emit(
            {
                "ph": "M",
                "name": "thread_name",
                "pid": self._pid,
                "tid": tid,
                "args": {"name": threading.current_thread().name},
            }
        )

    def complete(
        self,
        name: str,
        cat: Optional[str],
        t0: float,
        t1: Optional[float] = None,
        args: Optional[Dict[str, Any]] = None,
    ) -> None:
        """One completed span ``[t0, t1]`` (``ph: X``)."""
        t1 = time.perf_counter() if t1 is None else t1
        tid = threading.get_ident()
        self._thread_meta(tid)
        self._emit(
            {
                "name": name,
                "cat": cat or "run",
                "ph": "X",
                "ts": round(self._us(t0), 1),
                "dur": round((t1 - t0) * 1e6, 1),
                "pid": self._pid,
                "tid": tid,
                **({"args": args} if args else {}),
            }
        )

    def counter(self, name: str, values: Dict[str, float]) -> None:
        """A sampled counter series (``ph: C``), e.g. device memory in use."""
        self._emit(
            {"name": name, "ph": "C", "ts": round(self._us(time.perf_counter()), 1), "pid": self._pid, "args": values}
        )

    def instant(self, name: str, cat: Optional[str] = None, args: Optional[Dict[str, Any]] = None) -> None:
        """A zero-duration marker (``ph: i``), e.g. a health guard firing."""
        self._emit(
            {
                "name": name,
                "cat": cat or "health",
                "ph": "i",
                "s": "g",
                "ts": round(self._us(time.perf_counter()), 1),
                "pid": self._pid,
                "tid": threading.get_ident(),
                **({"args": args} if args else {}),
            }
        )

    def annotation(self, name: str):
        """A ``torch.profiler.record_function`` for the span while a profiler
        session records, else None."""
        if not self.xla_annotations or not _profiler_recording():
            return None
        try:
            from torch.profiler import record_function

            return record_function(name)
        except Exception:
            return None

    # -- lifecycle ----------------------------------------------------------

    def _flush_locked(self) -> None:
        if self._buffer and self._file is not None and not self._file.closed:
            self._file.write("\n".join(self._buffer) + "\n")
            self._file.flush()
        self._buffer.clear()

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def close(self) -> None:
        with self._lock:
            self._flush_locked()
            if self._file is not None and not self._file.closed:
                self._file.close()


class span(ContextDecorator):
    """``with span("Time/train_time", phase="train"): ...``

    Accumulates into the global :class:`timer` registry under ``name`` (same
    semantics, including the re-register after a concurrent reset) and, when
    a tracer is active, emits a trace event categorized under ``phase`` and
    mirrors the scope into a recording profiler.
    """

    def __init__(self, name: str, metric: Any = None, phase: Optional[str] = None):
        self.name = name
        self.phase = phase
        self._timer = timer(name, metric)
        self._t0: Optional[float] = None
        self._annotation = None

    def __enter__(self):
        tracer = _TRACER
        if tracer is not None or _hist.installed() is not None:
            self._t0 = time.perf_counter()
        if tracer is not None:
            self._annotation = tracer.annotation(self.name)
            if self._annotation is not None:
                self._annotation.__enter__()
        self._timer.__enter__()
        return self

    def __exit__(self, *exc):
        self._timer.__exit__(*exc)
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
            self._annotation = None
        if self._t0 is not None:
            t0, self._t0 = self._t0, None
            t1 = time.perf_counter()
            # histograms first: a slow-span trigger fired here lands its
            # flight dump before this very event rotates into the ring
            _hist.observe(self.name, t1 - t0)
            tracer = _TRACER
            if tracer is not None:
                tracer.complete(self.name, self.phase, t0, t1)
        # a profiler window closes at its deadline on the thread that opened it
        # (obs/prof/capture.py); outside a window this is two reads
        _capture.poll()
        return False

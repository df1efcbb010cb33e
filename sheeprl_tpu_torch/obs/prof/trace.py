"""Attribute a ``torch.profiler`` trace's device time to the steps that ran
it (counterpart of ``sheeprl_tpu/obs/prof/xplane.py``; the same summary
keys).

A "module" of the JAX package is a compiled XLA program, named on the
device plane's ``XLA Modules`` line. Here it is one of the port's steps: a
:class:`~sheeprl_tpu_torch.train.graphs.CapturedStep`, whose every call
(a CUDA-graph replay or an eager call) runs inside a
``record_function("step:<name>")`` range while a profiler records, or, for
work outside any step, the innermost span (``obs/spans.py`` mirrors spans
into ``record_function`` ranges while a profiler records). Each device
event (kernel, memcpy, memset) is attributed to the host runtime call that
launched it through the CUPTI correlation id (``cudaGraphLaunch`` for a
replayed graph's every kernel, ``cudaLaunchKernel`` and friends for an
eager one), and through that call's time and thread to the range it was
made in; a launch from a thread that opened no range (autograd's backward
thread) goes to the step range open on any thread at that moment.

One execution is one instance of a step's range; its device time runs from
its first device event's start to its last one's end (an XLA module event's
span, gaps inside included), so ``ms_per_exec`` needs no host-side step
count. A span's execution (the eager work of a phase outside its steps) and
the loose launches outside every range count their device events' own
time, so that a span holding a step's launch does not count it again. A
device trace's module also counts its ``replays`` (executions launched by
``cudaGraphLaunch``) and their ``ms_per_replay``, the span of the graph's
own kernels: a captured step's steady state, without the eager warm-up
calls a window may hold or a copy another thread ran beside it.
``top_ops`` is the kernels' self-time by name, a stack sweep per stream as
the JAX parser sweeps nested XLA ops.

**CPU fallback.** A CPU run has no device events: the step ranges' own host
time stands in for device time (the JAX parser's ``PjitFunction`` spans),
nested duplicates merged to their outermost range. Good enough for the
plumbing and for relative comparisons on one host.

Two sources, the same normalized events: a Chrome trace file
(``prof.export_chrome_trace``; :func:`load_trace`) and the profiler's raw
events (:func:`events_from_profiler`), which skip building
``key_averages()`` (seconds a window at tens of thousands of kernels).
Collective communication is the NCCL kernels' device time (the
data-parallel steps' all-reduces and gathers, ``obs/dist/comms.py``):
``comms_ms_total`` and ``comms_ms_by_kind`` (``all_reduce``,
``all_gather``, ``broadcast``, ``reduce_scatter``, ``send_recv``) sum the
``ncclDevKernel_*`` (``ncclKernel_*`` in older NCCL) records and a
one-rank world's ``oneRankReduce`` (:func:`nccl_kind`), 0.0 and empty on a
device trace without any; gloo's collectives run on the host and are
counted by the run's ``comms_*`` counters instead.
"""

from __future__ import annotations

import bisect
import collections
import glob
import gzip
import json
import os
import re
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "averaged_device_us",
    "device_durations",
    "device_us_by_name",
    "events_from_profiler",
    "find_trace",
    "load_trace",
    "phase_of",
    "summarize",
    "summarize_events",
]

#: the range a CapturedStep call runs in (``train/graphs.STEP_PREFIX``)
STEP_PREFIX = "step:"
#: device activity categories of a Chrome trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: host runtime categories that carry a launch's correlation id
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
#: ranges PyTorch opens itself (the optimizer's step, profiler steps): never a module
_INTERNAL_RANGES = re.compile(r"^(Optimizer\.|ProfilerStep#|## )")

# normalized event: (cat, name, ts_us, dur_us, tid, correlation)
Event = Tuple[str, str, float, float, Any, Optional[int]]


# -- sources ------------------------------------------------------------------


def find_trace(trace_dir: str) -> str:
    """Newest Chrome trace (``*.json`` or ``*.json.gz``) under ``trace_dir``,
    or the path itself when it already names a file."""
    if os.path.isfile(trace_dir):
        return trace_dir
    files = [
        f
        for pattern in ("*.json", "*.json.gz")
        for f in glob.glob(os.path.join(trace_dir, "**", pattern), recursive=True)
        if not os.path.basename(f).startswith("capture_")
    ]
    if not files:
        raise FileNotFoundError(f"no Chrome trace under {trace_dir}")
    return max(files, key=os.path.getmtime)


def load_trace(path: str) -> List[Event]:
    """The normalized complete events (``ph: X``) of one Chrome trace."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    raw = data.get("traceEvents", []) if isinstance(data, dict) else data
    out: List[Event] = []
    for e in raw:
        if not isinstance(e, dict) or e.get("ph") != "X":
            continue
        args = e.get("args") or {}
        corr = args.get("correlation")
        out.append(
            (
                str(e.get("cat", "")),
                str(e.get("name", "")),
                float(e.get("ts", 0.0)),
                float(e.get("dur", 0.0)),
                (e.get("pid"), e.get("tid")),
                int(corr) if corr is not None else None,
            )
        )
    return out


def _raw_category(e, on_device: bool) -> str:
    """A raw event's Chrome-trace category: its ``activity_type()`` where
    the PyTorch has it, else read off the event (a device event is a kernel
    unless its name says copy or set; a host range is a user annotation; a
    host ``cuda*``/``cu*`` call is the CUDA runtime's)."""
    name = e.name()
    if on_device and e.is_user_annotation():
        return "gpu_user_annotation"  # a range mirrored on the device's timeline: spans kernels counted on their own
    kind = getattr(e, "activity_type", None)
    cat = str(kind()) if kind is not None else None
    if on_device:
        if cat in DEVICE_CATS:
            return cat
        return "gpu_memcpy" if name.startswith("Memcpy") else "gpu_memset" if name.startswith("Memset") else "kernel"
    if cat:
        return cat
    if e.is_user_annotation():
        return "user_annotation"
    return "cuda_runtime" if name.startswith(("cuda", "cu")) else "cpu_op"


def events_from_profiler(prof) -> List[Event]:
    """The normalized events of a stopped ``torch.profiler.profile`` (or of
    a profiler session's results), read from its raw events (no
    ``key_averages()``): the device's, the user's ranges and the runtime
    calls; an operator's own record is skipped (it attributes nothing)."""
    from torch.autograd import DeviceType

    results = prof.profiler.kineto_results if hasattr(prof, "profiler") else prof
    out: List[Event] = []
    for e in results.events():
        on_device = e.device_type() == DeviceType.CUDA
        if not on_device and not e.is_user_annotation() and not e.name().startswith(("cuda", "cu")):
            continue
        tid = ("dev", e.device_index(), e.device_resource_id()) if on_device else ("host", e.start_thread_id())
        start_us = e.start_ns() / 1e3 if hasattr(e, "start_ns") else float(e.start_us())
        dur_us = e.duration_ns() / 1e3 if hasattr(e, "duration_ns") else float(e.duration_us())
        out.append((_raw_category(e, on_device), e.name(), start_us, dur_us, tid, int(e.correlation_id())))
    return out


def device_durations(prof) -> List[Tuple[str, float]]:
    """``(name, µs)`` of every device event (kernel, copy, set) of a stopped
    profiler, read from its raw events: the quick read where only the
    device's work is wanted (a whole run's trace holds 10^5-10^6 kernels)."""
    from torch.autograd import DeviceType

    results = prof.profiler.kineto_results if hasattr(prof, "profiler") else prof
    cuda = DeviceType.CUDA
    return [
        (e.name(), e.duration_ns() / 1e3)
        for e in results.events()
        if e.device_type() == cuda and not e.is_user_annotation()
    ]


def device_us_by_name(events) -> Dict[str, float]:
    """Device µs by kernel (or copy) name: of normalized events, or of a
    stopped profiler (read with :func:`device_durations`)."""
    out: Dict[str, float] = {}
    if not isinstance(events, list):
        for name, us in device_durations(events):
            out[name] = out.get(name, 0.0) + us
        return out
    for cat, name, _ts, dur, _tid, _corr in events:
        if cat in DEVICE_CATS:
            out[name] = out.get(name, 0.0) + dur
    return out


def averaged_device_us(evt) -> float:
    """Self device time (µs) of a ``key_averages()`` entry (the attribute
    was renamed across PyTorch versions); 0 for a user-annotated range,
    which spans kernels counted on their own."""
    if getattr(evt, "is_user_annotation", False):
        return 0.0
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(evt, attr, None)
        if value is not None:
            return float(value)
    return 0.0


# -- phase attribution --------------------------------------------------------

#: framework-phase heuristics over step / span names (the JAX parser's
#: patterns: the train steps are ``train_step``, spans ``Time/train_time``;
#: acting steps ``act``, the device rollout ``rollout``). First match wins;
#: unmatched modules report phase ``other``.
_PHASE_PATTERNS: Tuple[Tuple[str, "re.Pattern"], ...] = (
    ("train", re.compile(r"shmapped|burst|train|update|local_step", re.I)),
    ("rollout", re.compile(r"rollout|collect|scan_rollout", re.I)),
    ("act", re.compile(r"\bact|player|policy|greedy|sample_act", re.I)),
    ("staging", re.compile(r"gather|stage|prefetch|ring|sample", re.I)),
    ("publish", re.compile(r"publish|broadcast", re.I)),
)


def phase_of(module_name: str) -> str:
    """Map a step / span name onto a framework phase name."""
    for phase, pattern in _PHASE_PATTERNS:
        if pattern.search(module_name):
            return phase
    return "other"


def _clean_module_name(name: str) -> str:
    """``step:train_step`` -> ``train_step``."""
    return name[len(STEP_PREFIX):] if name.startswith(STEP_PREFIX) else name


# -- summarize ----------------------------------------------------------------


def _merge_outermost(intervals: List[Tuple[float, float]]) -> Tuple[int, float]:
    """(execs, total) counting only outermost intervals: nested duplicates
    (a range inside a range of the same name) are one execution."""
    execs = 0
    total = 0.0
    current_end = float("-inf")
    for start, end in sorted(intervals):
        if start >= current_end:
            execs += 1
            total += end - start
            current_end = end
        elif end > current_end:  # partial overlap: extend, same execution
            total += end - current_end
            current_end = end
    return execs, total


def _module_records(events: Iterable[Tuple[str, float, float]]) -> Dict[str, Dict[str, Any]]:
    """name -> {execs, total_ms, ms_per_exec, phase} from (name, start_us, dur_us)."""
    by_name: Dict[str, List[Tuple[float, float]]] = collections.defaultdict(list)
    for name, start, dur in events:
        by_name[name].append((start, start + dur))
    out: Dict[str, Dict[str, Any]] = {}
    for name, intervals in by_name.items():
        execs, total_us = _merge_outermost(intervals)
        if execs == 0:
            continue
        out[name] = {
            "execs": execs,
            "total_ms": total_us / 1e3,
            "ms_per_exec": total_us / 1e3 / execs,
            "phase": phase_of(name),
        }
    return out


def _kernel_self_times(device: List[Event]) -> "collections.Counter":
    """Per-kernel-name self-time (µs): a stack sweep per stream, so an event
    nested in another on its stream counts only once."""
    self_time: collections.Counter = collections.Counter()
    by_stream: Dict[Any, List[Tuple[float, float, str]]] = collections.defaultdict(list)
    for _c, name, ts, dur, tid, _corr in device:
        by_stream[tid].append((ts, ts + dur, name))
    for evs in by_stream.values():
        stack: List[Tuple[float, float, str]] = []
        for start, end, name in sorted(evs):
            while stack and stack[-1][1] <= start:
                stack.pop()
            if stack:
                self_time[stack[-1][2]] -= min(end, stack[-1][1]) - start
            self_time[name] += end - start
            stack.append((start, end, name))
    return self_time


class _Ranges:
    """Ranges by thread, for "which range was open on this thread at time
    t". Ranges on one thread nest or are disjoint, so each keeps a pointer
    to the range enclosing it and a query walks the nesting, not the list."""

    def __init__(self, ranges: List[Event]):
        self.by_tid: Dict[Any, Tuple[List[float], List[Event], List[int]]] = {}
        grouped: Dict[Any, List[Event]] = collections.defaultdict(list)
        for r in ranges:
            grouped[r[4]].append(r)
        for tid, rs in grouped.items():
            rs.sort(key=lambda r: (r[2], -r[3]))
            parent, stack = [], []
            for i, r in enumerate(rs):
                while stack and rs[stack[-1]][2] + rs[stack[-1]][3] < r[2]:
                    stack.pop()
                parent.append(stack[-1] if stack else -1)
                stack.append(i)
            self.by_tid[tid] = ([r[2] for r in rs], rs, parent)

    def innermost(self, tid, ts: float) -> Optional[Event]:
        """The innermost range open at ``ts`` on ``tid`` (on any thread, the
        latest-starting one, when ``tid`` is None)."""
        best: Optional[Event] = None
        tids = self.by_tid if tid is None else ([tid] if tid in self.by_tid else [])
        for t in tids:
            starts, rs, parent = self.by_tid[t]
            i = bisect.bisect_right(starts, ts) - 1
            while i >= 0 and rs[i][2] + rs[i][3] < ts:
                i = parent[i]
            if i >= 0 and (best is None or rs[i][2] > best[2]):
                best = rs[i]
        return best


_NCCL_KERNEL = re.compile(r"^nccl(?:Dev)?Kernel_([A-Za-z]+)")
_NCCL_KINDS = {"AllReduce": "all_reduce", "AllGather": "all_gather", "Broadcast": "broadcast",
               "ReduceScatter": "reduce_scatter", "SendRecv": "send_recv", "Reduce": "reduce"}


def nccl_kind(name: str) -> Optional[str]:
    """The collective kind of an NCCL kernel's name (``ncclDevKernel_*``,
    ``ncclKernel_*``; ``oneRankReduce``, the all-reduce of a world of one
    rank with a scaled sum such as an average), else None."""
    m = _NCCL_KERNEL.match(name)
    if m:
        return _NCCL_KINDS.get(m.group(1), m.group(1).lower())
    return "all_reduce" if "oneRankReduce" in name else None


def comms_ms_by_kind(device: Iterable[Event]) -> Dict[str, float]:
    """The NCCL kernels' device milliseconds by collective kind."""
    out: Dict[str, float] = {}
    for _c, name, _ts, dur, _tid, _corr in device:
        kind = nccl_kind(name)
        if kind is not None:
            out[kind] = out.get(kind, 0.0) + dur / 1e3
    return out


def summarize_events(events: List[Event]) -> Dict[str, Any]:
    """Attribute one trace's normalized events: per-module executions and
    device time.

    Returns::

        {
          "source":       "device" | "host",   # which events were attributable
          "plane":        "/device:GPU" | "/host:CPU",
          "modules":      {name: {execs, total_ms, ms_per_exec, phase}},
          "train_module": name | None,         # dominant phase=='train' module
          "window_ms":    first module start -> last module end,
          "busy_ms":      sum of module time,
          "busy_frac":    busy_ms / window_ms (device idleness == dispatch gaps),
          "steps_ms_total": None (no step line in a torch trace),
          "top_ops":      {kernel: self_ms_total} (device traces, else {}),
          "kernel_counts": {kernel: executions} (device traces, else {}),
          "comms_ms_total", "comms_ms_by_kind": the NCCL kernels' ms (device), None (host),
        }
    """
    device = [e for e in events if e[0] in DEVICE_CATS]
    annotations = [e for e in events if e[0] == "user_annotation" and not _INTERNAL_RANGES.match(e[1])]
    if device:
        runtime = {e[5]: e for e in events if e[0] in RUNTIME_CATS and e[5] is not None}
        step_ranges = _Ranges([e for e in annotations if e[1].startswith(STEP_PREFIX)])
        step_names = {_clean_module_name(e[1]) for e in annotations if e[1].startswith(STEP_PREFIX)}
        span_ranges = _Ranges([e for e in annotations if not e[1].startswith(STEP_PREFIX)])
        # one execution of a module: one instance of its range (loose kernels: one instance in all), with the
        # device intervals its launches ran and whether one of them replayed a CUDA graph
        instances: Dict[Tuple[str, Any], List[Any]] = {}
        for _c, _n, ts, dur, _tid, corr in device:
            launch = runtime.get(corr)
            owner = None
            if launch is not None:
                owner = (
                    step_ranges.innermost(launch[4], launch[2])
                    or span_ranges.innermost(launch[4], launch[2])
                    or step_ranges.innermost(None, launch[2])
                )
            key = ("eager", None) if owner is None else (_clean_module_name(owner[1]), (owner[4], owner[2]))
            entry = instances.setdefault(key, [[], []])
            entry[0].append((ts, ts + dur))
            if launch is not None and launch[1].startswith("cudaGraphLaunch"):
                entry[1].append((ts, ts + dur))
        module_events = []
        replay_events = []
        for (name, _inst), (intervals, graphed) in instances.items():
            if name in step_names:
                # a step's execution: its first device event's start to its last one's end (gaps included)
                start, end = min(s for s, _e in intervals), max(e for _s, e in intervals)
                module_events.append((name, start, end - start))
                if graphed:  # a replay: the graph's own kernels (not a copy another thread ran beside it)
                    start, end = min(s for s, _e in graphed), max(e for _s, e in graphed)
                    replay_events.append((name, start, end - start))
            else:
                # work outside the steps (a span's eager kernels, loose launches): its own device time, no gaps,
                # so a span holding a step's launch does not count the step's time again
                _n, busy = _merge_outermost(intervals)
                module_events.append((name, min(s for s, _e in intervals), busy))
        modules = _module_records(module_events)
        # the executions that replayed a CUDA graph apart: a step's steady state, without its eager warm-up calls
        replays = _module_records(replay_events)
        for name, m in modules.items():
            r = replays.get(name)
            m["replays"] = r["execs"] if r else 0
            m["ms_per_replay"] = r["ms_per_exec"] if r else None
        out = _assemble("/device:GPU", "device", modules, module_events)
        self_times = _kernel_self_times(device)
        out["steps_ms_total"] = None
        out["top_ops"] = {name: us / 1e3 for name, us in self_times.most_common(30)}
        out["kernel_counts"] = dict(collections.Counter(e[1] for e in device))
        out["comms_ms_by_kind"] = comms_ms_by_kind(device)
        out["comms_ms_total"] = float(sum(out["comms_ms_by_kind"].values()))
        return out

    # CPU fallback: the step ranges' host time (span ranges where no step ran)
    steps = [e for e in annotations if e[1].startswith(STEP_PREFIX)] or annotations
    if not steps:
        raise FileNotFoundError("no attributable events in the trace (no device events, no step or span ranges)")
    module_events = [(_clean_module_name(e[1]), e[2], e[3]) for e in steps]
    modules = _module_records(module_events)
    out = _assemble("/host:CPU", "host", modules, module_events)
    out["steps_ms_total"] = None
    out["top_ops"] = {}
    out["kernel_counts"] = {}
    out["comms_ms_total"] = None
    out["comms_ms_by_kind"] = None
    return out


def _assemble(
    plane: str, source: str, modules: Dict[str, Dict[str, Any]], events: List[Tuple[str, float, float]]
) -> Dict[str, Any]:
    # window = first module start -> last module end, not the whole trace:
    # profiler set-up would otherwise dilute busy_frac into a spurious
    # dispatch-bound verdict
    starts = [s for _n, s, _d in events]
    ends = [s + d for _n, s, d in events]
    window_ms = (max(ends) - min(starts)) / 1e3 if starts else 0.0
    busy_ms = sum(m["total_ms"] for m in modules.values())
    train_candidates = {n: m for n, m in modules.items() if m["phase"] == "train"} or modules
    train_module = (
        max(train_candidates, key=lambda n: train_candidates[n]["total_ms"]) if train_candidates else None
    )
    return {
        "source": source,
        "plane": plane,
        "modules": modules,
        "train_module": train_module,
        "window_ms": round(window_ms, 3),
        "busy_ms": round(busy_ms, 3),
        "busy_frac": round(busy_ms / window_ms, 4) if window_ms > 0 else None,
    }


def summarize(trace: str, n_steps: Optional[int] = None) -> Dict[str, Any]:
    """Parse the newest Chrome trace under ``trace`` (a directory or a file).

    :func:`summarize_events` plus, when ``n_steps`` is given, the per-step
    keys of the JAX parser (``modules_us_per_step`` / ``steps_us_per_step``
    / ``top_ops`` in µs a step)."""
    out = summarize_events(load_trace(find_trace(trace)))
    if n_steps is not None:
        denom = max(n_steps, 1)
        out["modules_us_per_step"] = out["busy_ms"] * 1e3 / denom if out["modules"] else None
        out["steps_us_per_step"] = None
        out["top_ops"] = {k: v * 1e3 / denom for k, v in out["top_ops"].items()}
    return out

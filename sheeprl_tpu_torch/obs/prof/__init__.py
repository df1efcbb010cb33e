"""Device-time profiling and roofline attribution (counterpart of
``sheeprl_tpu/obs/prof``).

The run telemetry's spans measure host wall time per phase; this package
measures where the card's time goes and what binds it. Four pieces:

- :mod:`~sheeprl_tpu_torch.obs.prof.trace`: attributes a ``torch.profiler``
  trace's device time (Chrome trace or the profiler's raw events) to the
  port's steps (CUDA-graph replays and eager calls, through the launches'
  correlation ids) and spans, per execution, with a host fallback so CPU
  runs profile too, and maps step names onto phase names;
- :mod:`~sheeprl_tpu_torch.obs.prof.roofline`: the step's counted FLOPs and
  bytes against measured device time: MFU, achieved bandwidth, and a
  compute- / memory- / dispatch-bound verdict against a device-peak
  registry (the H100's 989.4 TFLOP/s and 3.35 TB/s; a CPU estimate);
- :mod:`~sheeprl_tpu_torch.obs.prof.capture`: the in-run capture scheduler:
  ``profile_tick`` (every entrypoint's log boundary) opens a window every
  ``metric.telemetry.profile.every_n_steps`` policy steps, parses it off the
  loop's thread and folds ``device_ms_per_step`` / ``mfu_device_pct`` /
  ``roofline_verdict`` into ``telemetry.json`` and ``live.json``;
- :mod:`~sheeprl_tpu_torch.obs.prof.harness`: one builder of a family's
  real train step on synthetic data, used by
  ``sheeprl_tpu_torch.tools.roofline_report`` and the benches.

Names load on first use (no torch at import).
"""

import importlib

_EXPORTS = {
    "StepProfiler": "capture",
    "analyze_trace": "capture",
    "end_capture": "capture",
    "parse_and_fold": "capture",
    "profile_tick": "capture",
    "try_begin_capture": "capture",
    "DEVICE_PEAKS": "roofline",
    "cost_of": "roofline",
    "detect_peaks": "roofline",
    "roofline_analyze": "roofline",
    "events_from_profiler": "trace",
    "find_trace": "trace",
    "load_trace": "trace",
    "phase_of": "trace",
    "summarize": "trace",
    "summarize_events": "trace",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)

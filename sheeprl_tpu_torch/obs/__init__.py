"""Run telemetry of the port (counterpart of ``sheeprl_tpu/obs/``): phase
spans, device/transfer/graph counters, health guards, the live plane and the
end-of-run ``telemetry.json``.

- :mod:`~sheeprl_tpu_torch.obs.spans`: Chrome trace-event spans layered on
  the ``timer`` registry;
- :mod:`~sheeprl_tpu_torch.obs.counters`: host→device byte accounting,
  CUDA-graph captures and replays, a device-memory poller;
- :mod:`~sheeprl_tpu_torch.obs.health`: NaN/inf guards on logged losses and
  a stall watchdog for decoupled players;
- :mod:`~sheeprl_tpu_torch.obs.perf`: the ``Time/sps_*`` / ``Perf/mfu``
  gauges every loop logs through;
- :mod:`~sheeprl_tpu_torch.obs.hist`: mergeable log-bucket histograms of
  every span duration;
- :mod:`~sheeprl_tpu_torch.obs.live`: ``telemetry/live.json``, the optional
  Prometheus endpoint, the flight recorder;
- :mod:`~sheeprl_tpu_torch.obs.dist`: the cross-process merge and the
  data-staleness lineage.

Everything is configured by the ``metric.telemetry`` config group and is
off by default; disabled, a span is a plain ``timer`` and no file, thread,
histogram or flight ring exists. Two planes sit beside these:

- :mod:`~sheeprl_tpu_torch.obs.prof`: ``torch.profiler`` capture windows,
  the Chrome-trace parser and the roofline (``device_ms_per_step``,
  ``mfu_device_pct``, ``roofline_verdict``);
- :mod:`~sheeprl_tpu_torch.obs.learn`: learn probes computed inside the
  train step and the divergence sentinel over them.

Names load on first use, so ``import sheeprl_tpu_torch.obs`` costs
nothing.
"""

import importlib

_EXPORTS = {
    "Counters": "counters",
    "DevicePoller": "counters",
    "add_act_dispatches": "counters",
    "add_ckpt_blocked_ms": "counters",
    "add_ckpt_write": "counters",
    "add_env_async_steps": "counters",
    "add_env_degraded": "counters",
    "add_env_worker_restart": "counters",
    "add_h2d_bytes": "counters",
    "add_plane_player_restart": "counters",
    "add_plane_slabs": "counters",
    "add_prefetch": "counters",
    "add_ring_gather": "counters",
    "add_rollout_burst": "counters",
    "count_h2d": "counters",
    "device_memory_stats": "counters",
    "note_plane_policy_version": "counters",
    "set_shard_footprint": "counters",
    "staged_device_put": "counters",
    "tree_nbytes": "counters",
    "StalenessTracker": "dist.staleness",
    "NonFiniteGuard": "health",
    "StallWatchdog": "health",
    "HistogramSet": "hist",
    "StreamingHist": "hist",
    "FlightRecorder": "live",
    "LiveExporter": "live",
    "PromServer": "live",
    "prometheus_text": "live",
    "PEAK_TFLOPS_BF16": "perf",
    "LoopProbe": "perf",
    "count_cost": "perf",
    "log_sps_metrics": "perf",
    "mfu_pct": "perf",
    "register_step_cost": "perf",
    "register_train_cost": "perf",
    "TraceWriter": "spans",
    "get_tracer": "spans",
    "set_tracer": "spans",
    "span": "spans",
    "LEARN_PREFIX": "learn",
    "LearnSentinel": "learn",
    "learn_probes": "learn",
    "observe_probes": "learn",
    "probes_enabled": "learn",
    "StepProfiler": "prof",
    "detect_peaks": "prof",
    "profile_tick": "prof",
    "roofline_analyze": "prof",
    "Telemetry": "telemetry",
    "finalize_telemetry": "telemetry",
    "get_telemetry": "telemetry",
    "setup_telemetry": "telemetry",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)

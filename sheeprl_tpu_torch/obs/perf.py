"""The training loops' rate gauges (counterpart of ``log_sps_metrics`` in
``sheeprl_tpu/obs/perf.py``).

The JAX function also feeds the run telemetry and logs ``Perf/mfu`` from the
train step's registered FLOPs; both wait for the port's telemetry (ROADMAP
queue A item 6h) and are left out here.
"""

from __future__ import annotations

from typing import Dict

from sheeprl_tpu_torch.utils.timer import timer

__all__ = ["log_sps_metrics"]


def log_sps_metrics(
    logger,
    *,
    policy_step: int,
    last_log: int,
    train_step: int = 0,
    last_train: int = 0,
    world_size: int = 1,
    action_repeat: int = 1,
) -> Dict[str, float]:
    """Compute the rate gauges from the timer registry, log them at
    ``policy_step`` and return them: ``Time/sps_train`` (train steps per
    second of timed train wall) and ``Time/sps_env_interaction``
    (per-process env steps × ``action_repeat`` per second of timed
    interaction wall), and the seconds the window spent waiting
    (``Time/plane_wait_time``: a decoupled learner for its players' slabs;
    ``Time/env_wait_time``: a worker pool for its workers' steps, in this
    process). Reads and resets the registry (``timer.compute``), so call it
    once a log boundary; with the timers disabled it logs nothing."""
    if timer.disabled:
        return {}
    timer_metrics = timer.compute()
    train_s = timer_metrics.get("Time/train_time")
    env_s = timer_metrics.get("Time/env_interaction_time")
    gauges: Dict[str, float] = {}
    if train_s:
        gauges["Time/sps_train"] = (train_step - last_train) / max(train_s, 1e-9)
    if env_s:
        gauges["Time/sps_env_interaction"] = ((policy_step - last_log) / world_size * action_repeat) / max(env_s, 1e-9)
    for name in ("Time/plane_wait_time", "Time/env_wait_time"):
        if timer_metrics.get(name):
            gauges[name] = timer_metrics[name]
    if logger is not None and gauges:
        logger.log_metrics(gauges, policy_step)
    return gauges

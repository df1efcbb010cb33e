"""SPS / MFU gauges: the one implementation every entrypoint logs through
(counterpart of ``sheeprl_tpu/obs/perf.py``).

:func:`log_sps_metrics` is the single computation of the ``Time/sps_*``
rate gauges and ``Perf/mfu``: the loops call it at their log boundary, and
``tests/test_torch_lint_telemetry.py`` fails when a loop grows its own
``Time/sps_`` literal or reads a clock of its own.

A train step's FLOPs are counted once per run with
``torch.utils.flop_counter.FlopCounterMode`` over one eager call of the
step, the first warm-up call that ``train/graphs.CapturedStep`` makes anyway
(never inside a capture): :func:`count_cost`. The counter sees the matrix
products and convolutions that PyTorch dispatches, forward and backward;
the products inside the port's own CUDA kernels, which it cannot see, their
wrappers add from their shapes (:func:`add_kernel_flops`), so a step counts
the same on the card as on the CPU. Elementwise work and reductions are not
counted (the JAX package takes XLA's cost analysis of the whole program).

The same call counts the step's bytes (:func:`count_cost`): a
``TorchDispatchMode`` sums every PyTorch operation's input and output bytes,
views excepted, and the kernels' wrappers add theirs
(:func:`add_kernel_bytes`). That is an unfused upper bound, as XLA's "bytes
accessed" is: an operation's inputs are read and its outputs written once
each, whatever a fused kernel would keep on chip. It is the in-run
roofline's bandwidth numerator (``obs/prof``).
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

__all__ = [
    "LoopProbe",
    "PEAK_TFLOPS_BF16",
    "PhaseSeconds",
    "add_kernel_bytes",
    "add_kernel_flops",
    "count_cost",
    "log_sps_metrics",
    "mfu_pct",
    "register_step_cost",
    "register_train_cost",
]

#: H100 SXM dense bf16 tensor-core peak in TFLOP/s, the default MFU
#: denominator (``metric.telemetry.peak_tflops`` overrides; f32 programs are
#: measured against the same bf16 peak, as in the JAX package, so numbers
#: stay comparable across precisions)
PEAK_TFLOPS_BF16 = 989.4

#: the products the port's kernels ran during a count_cost call (None outside one)
_KERNEL_FLOPS: Optional[List[int]] = None
#: the bytes the port's kernels moved during a count_cost call (None outside one)
_KERNEL_BYTES: Optional[List[int]] = None


class LoopProbe:
    """Env-gated per-phase wall-time probe for latency-dominated hot loops.

    ``SHEEPRL_LOOP_TRACE=1`` prints the mean per-iteration wall time of each
    ``lap``-delimited slice every ``every`` iterations. The loops use this
    instead of hand-rolled ``time.perf_counter()`` deltas; when the env var
    is unset every call is a single attribute check.
    """

    __slots__ = ("enabled", "every", "_acc", "_n", "_t")

    def __init__(self, every: int = 50, env_var: str = "SHEEPRL_LOOP_TRACE"):
        self.enabled = os.environ.get(env_var) not in (None, "", "0")
        self.every = int(every)
        self._acc: Dict[str, float] = {}
        self._n = 0
        self._t = 0.0

    def mark(self) -> None:
        """Start (or restart) the slice clock: call at the top of the loop."""
        if self.enabled:
            self._t = time.perf_counter()

    def lap(self, name: str) -> None:
        """Account the time since the last mark/lap to ``name``."""
        if self.enabled:
            t = time.perf_counter()
            self._acc[name] = self._acc.get(name, 0.0) + (t - self._t)
            self._t = t

    def tick(self, update: int) -> None:
        """End of one iteration; prints and resets every ``every`` calls."""
        if not self.enabled:
            return
        self._n += 1
        if self._n % self.every == 0:
            parts = " ".join(f"{k}={v / self.every * 1000:.0f}ms" for k, v in sorted(self._acc.items()))
            print(f"[loop-trace] update={update} mean/iter: {parts}", flush=True)
            self._acc.clear()


class PhaseSeconds(dict):
    """A run's host seconds by phase, the ``seconds`` of a loop's result:
    ``with seconds.phase("env"): ...`` adds the block's wall seconds to
    ``seconds["env"]``. The loops time their phases through this (and
    :class:`~sheeprl_tpu_torch.obs.spans.span`), never with a clock read of
    their own."""

    def __init__(self, *phases: str):
        super().__init__(dict.fromkeys(phases, 0.0))

    @contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self[name] = self.get(name, 0.0) + time.perf_counter() - t0


def _nbytes(t) -> int:
    """A tensor's bytes, at most its storage's (a broadcast view is read once)."""
    n = t.numel() * t.element_size()
    try:
        return min(n, t.untyped_storage().nbytes())
    except Exception:
        return n


def _byte_counter():
    """A ``TorchDispatchMode`` summing every operation's input and output
    bytes into ``.total`` (views and metadata operations move none)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class ByteCounter(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not getattr(func, "is_view", False):
                self.total += sum(
                    _nbytes(t) for t in tree_leaves((args, kwargs, out)) if isinstance(t, torch.Tensor)
                )
            return out

    return ByteCounter()


def count_cost(fn: Callable[[], Any]) -> Tuple[Any, int, int]:
    """``(fn(), flops, bytes)``: one eager call under ``FlopCounterMode``
    (matrix products and convolutions, forward and backward) and the byte
    counter (every operation's inputs and outputs, an unfused upper bound),
    plus what the port's kernels add. Never call it inside a CUDA-graph
    capture."""
    from torch.utils.flop_counter import FlopCounterMode

    global _KERNEL_FLOPS, _KERNEL_BYTES
    counter = FlopCounterMode(display=False)
    nbytes = _byte_counter()
    _KERNEL_FLOPS, _KERNEL_BYTES = [0], [0]
    try:
        with counter, nbytes:
            out = fn()
        return out, int(counter.get_total_flops()) + _KERNEL_FLOPS[0], int(nbytes.total) + _KERNEL_BYTES[0]
    finally:
        _KERNEL_FLOPS = _KERNEL_BYTES = None


def add_kernel_flops(flops: int) -> None:
    """A hand-written kernel's product (``2·M·K·N``) inside a
    :func:`count_cost` call; a no-op outside one."""
    acc = _KERNEL_FLOPS
    if acc is not None:
        acc[0] += int(flops)


def add_kernel_bytes(nbytes: int) -> None:
    """A hand-written kernel's bytes (each input read and each output
    written once) inside a :func:`count_cost` call; a no-op outside one."""
    acc = _KERNEL_BYTES
    if acc is not None:
        acc[0] += int(nbytes)


def wants_train_flops() -> bool:
    """Should a train step count its FLOPs on its next eager call?"""
    from sheeprl_tpu_torch.obs.telemetry import get_telemetry

    telemetry = get_telemetry()
    return telemetry is not None and telemetry.needs_train_flops()


def register_train_cost(
    telemetry, step_flops: Optional[float], step_bytes: Optional[float] = None, *, dispatches_per_step: int = 1,
    world_size: int = 1,
) -> None:
    """Register the counted FLOPs and bytes of one train-step call with the
    run telemetry per unit of the loop's train-step counter: the counter
    advances by ``world_size`` per training block, which calls the step
    ``dispatches_per_step`` times, so the registered cost is
    ``step_cost × dispatches_per_step / world_size``."""
    if telemetry is None:
        return
    dps = max(int(dispatches_per_step), 1)
    ws = max(int(world_size), 1)
    telemetry.set_train_cost(
        step_flops * dps / ws if step_flops else None,
        step_bytes * dps / ws if step_bytes else None,
        dispatches_per_step=dps,
    )


def register_step_cost(step, *, dispatches_per_step: int = 1, world_size: int = 1) -> None:
    """:func:`register_train_cost` of a :class:`~sheeprl_tpu_torch.train.graphs.CapturedStep`
    that counted its FLOPs, once per run; a no-op with telemetry off."""
    from sheeprl_tpu_torch.obs.telemetry import get_telemetry

    telemetry = get_telemetry()
    if telemetry is None or not telemetry.needs_train_flops() or getattr(step, "flops", None) is None:
        return
    register_train_cost(telemetry, step.flops, getattr(step, "bytes", None), dispatches_per_step=dispatches_per_step,
                        world_size=world_size)


def mfu_pct(
    flops_per_step: Optional[float],
    steps: float,
    seconds: Optional[float],
    peak_tflops: float = PEAK_TFLOPS_BF16,
) -> Optional[float]:
    """Model FLOPs utilization in percent, or None when unmeasurable."""
    if not flops_per_step or not seconds or seconds <= 0 or steps <= 0 or peak_tflops <= 0:
        return None
    return round(flops_per_step * steps / seconds / (peak_tflops * 1e12) * 100.0, 3)


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
    ``policy_step``, feed the run telemetry, and return them:
    ``Time/sps_train`` (train steps per second of timed train wall),
    ``Time/sps_env_interaction`` (per-process env steps × ``action_repeat``
    per second of timed interaction wall), the seconds the window spent
    waiting (``Time/plane_wait_time``: a decoupled learner for its players'
    slabs; ``Time/env_wait_time``: a worker pool for its workers' steps),
    and, once the loop registered its train step's FLOPs with the telemetry,
    ``Perf/mfu``. Reads and resets the registry (``timer.compute``), so call
    it once a log boundary."""
    from sheeprl_tpu_torch.obs.telemetry import get_telemetry
    from sheeprl_tpu_torch.utils.timer import timer

    telemetry = get_telemetry()
    train_steps = train_step - last_train
    policy_steps = policy_step - last_log
    if timer.disabled:
        # metric.disable_timer=True: the telemetry's step totals stay exact without rate gauges
        if telemetry is not None:
            telemetry.record_window(policy_steps=policy_steps, train_steps=train_steps)
        return {}
    timer_metrics = timer.compute()
    train_s = timer_metrics.get("Time/train_time")
    env_s = timer_metrics.get("Time/env_interaction_time")
    gauges: Dict[str, float] = {}
    if train_s:
        gauges["Time/sps_train"] = train_steps / max(train_s, 1e-9)
    if env_s:
        gauges["Time/sps_env_interaction"] = (policy_steps / world_size * action_repeat) / max(env_s, 1e-9)
    for name in ("Time/plane_wait_time", "Time/env_wait_time"):
        if timer_metrics.get(name):
            gauges[name] = timer_metrics[name]
    if telemetry is not None:
        telemetry.record_window(
            policy_steps=policy_steps,
            train_steps=train_steps,
            env_seconds=env_s or 0.0,
            train_seconds=train_s or 0.0,
            stage_seconds=timer_metrics.get("Time/stage_h2d_time", 0.0),
        )
        mfu = mfu_pct(telemetry.flops_per_train_step, train_steps, train_s, telemetry.peak_tflops)
        if mfu is not None:
            gauges["Perf/mfu"] = mfu
    if logger is not None and gauges:
        logger.log_metrics(gauges, policy_step)
    return gauges

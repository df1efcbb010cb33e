"""Roofline accounting: FLOPs and bytes against measured device time
(counterpart of ``sheeprl_tpu/obs/prof/roofline.py``).

For a profiled step we know its cost (FLOPs and bytes, counted once per run
on one eager call: :func:`cost_of`) and its measured per-execution device
time (:mod:`~sheeprl_tpu_torch.obs.prof.trace`), so we can say whether the
card was bound by **compute** (MFU is the ceiling), **memory bandwidth**
(achieved GB/s is the ceiling), or by **dispatch gaps** (the device sat idle
waiting on the host, and no kernel work will help until the host path does).

Peak numbers come from a small registry keyed on
``torch.cuda.get_device_name()``, with a CPU fallback estimated from the
core count: estimated peaks are flagged ``estimated: True`` and keep the
*relative* verdicts meaningful on hosts without a card (tests, CPU runs).
"""

from __future__ import annotations

import os
import re
from typing import Any, Callable, Dict, Optional

__all__ = ["DEVICE_PEAKS", "compute_dtype", "compute_peak", "cost_of", "detect_peaks", "roofline_analyze"]

#: device-name pattern -> peaks (dense bf16 tensor-core TFLOP/s, memory GB/s,
#: and where known the dense TF32 tensor-core and the float32 SIMT TFLOP/s),
#: single-card datasheet numbers. The MFU denominator stays the bf16 peak for
#: f32 programs too (the convention of ``obs/perf.py``); the H100's is the
#: port's ``metric.telemetry.peak_tflops`` default. The verdict weighs the
#: FLOP rate against the peak of the step's own compute type
#: (:func:`compute_peak`): an f32 step held to the bf16 peak would read
#: memory-bound at any FLOP rate the f32 units can reach.
DEVICE_PEAKS = (
    (r"H100", {"label": "H100", "peak_tflops": 989.4, "peak_gbps": 3350.0, "peak_tflops_tf32": 494.7,
               "peak_tflops_f32": 66.9}),
    (r"A100", {"label": "A100", "peak_tflops": 312.0, "peak_gbps": 2039.0, "peak_tflops_tf32": 156.0,
               "peak_tflops_f32": 19.5}),
    (r"V100", {"label": "V100", "peak_tflops": 125.0, "peak_gbps": 900.0}),
    (r"RTX 3080|GeForce RTX 3080", {"label": "RTX 3080", "peak_tflops": 59.5, "peak_gbps": 760.0}),
)


def _cpu_peaks() -> Dict[str, Any]:
    """Order-of-magnitude CPU peaks so the roofline runs everywhere: 32
    FLOPs/cycle/core at a nominal 3 GHz, and a nominal dual-channel DDR
    bandwidth. Flagged estimated: the verdicts stay comparative."""
    cores = os.cpu_count() or 1
    peak = round(cores * 3.0e9 * 32 / 1e12, 2)
    return {
        "label": f"CPU ({cores} cores, estimated)",
        "peak_tflops": peak,
        "peak_gbps": 64.0,
        "peak_tflops_f32": peak,
        "estimated": True,
    }


def detect_peaks(
    peak_tflops: Optional[float] = None, peak_gbps: Optional[float] = None, device: Any = None
) -> Dict[str, Any]:
    """Peak numbers of ``device`` (default: the first card when one is
    visible, else the CPU), overridable. Returns ``{label, platform,
    device_kind, peak_tflops, peak_gbps, estimated}``; explicit overrides win
    over the registry, and only a full override clears ``estimated``."""
    platform = kind = "cpu"
    try:
        import torch

        dev = torch.device(device) if device is not None else None
        if (dev is None or dev.type == "cuda") and torch.cuda.is_available():
            platform, kind = "gpu", torch.cuda.get_device_name(dev if dev is not None and dev.index is not None else 0)
    except Exception:
        pass
    peaks: Dict[str, Any] = {"estimated": False}
    if platform == "cpu":
        peaks.update(_cpu_peaks())
    else:
        for pattern, entry in DEVICE_PEAKS:
            if re.search(pattern, kind, re.I):
                peaks.update(entry)
                break
        else:
            peaks.update({"label": kind, "peak_tflops": None, "peak_gbps": None})
    peaks["platform"] = platform
    peaks["device_kind"] = kind
    if peak_tflops:
        peaks["peak_tflops"] = float(peak_tflops)
    if peak_gbps:
        peaks["peak_gbps"] = float(peak_gbps)
    if peak_tflops and peak_gbps:
        peaks["estimated"] = False
    return peaks


def compute_dtype(precision: Any = None) -> str:
    """The compute type of a step run at ``fabric.precision``: ``bf16``
    under ``bf16-mixed``, else ``tf32`` where PyTorch lets f32 products use
    the TF32 tensor cores, else ``f32``."""
    if "bf16" in str(precision or "").lower():
        return "bf16"
    try:
        import torch

        if torch.backends.cuda.matmul.allow_tf32:
            return "tf32"
    except Exception:
        pass
    return "f32"


def compute_peak(peaks: Dict[str, Any], dtype: Optional[str]) -> Optional[float]:
    """The peak TFLOP/s of ``dtype`` (``bf16``, ``tf32``, ``f32``) in
    ``peaks``: the bf16 peak for bf16 or when the card's entry has none for
    the type (then the verdict leans as the MFU does)."""
    if dtype in ("tf32", "f32"):
        return peaks.get(f"peak_tflops_{dtype}") or peaks.get("peak_tflops")
    return peaks.get("peak_tflops")


# -- cost ---------------------------------------------------------------------


def cost_of(fn: Callable[[], Any]) -> Optional[Dict[str, float]]:
    """``{"flops", "bytes_accessed"}`` of one eager call of ``fn`` (no
    arguments), counted by :func:`~sheeprl_tpu_torch.obs.perf.count_cost`, or
    None when the call cannot be counted (a missing cost must never break a
    run). The bytes are an unfused upper bound: every PyTorch operation's
    inputs read and outputs written once, as XLA's "bytes accessed" counts
    each HLO op; the port's CUDA kernels add theirs from their shapes."""
    from sheeprl_tpu_torch.obs.perf import count_cost

    try:
        _, flops, nbytes = count_cost(fn)
    except Exception:
        return None
    return {"flops": float(flops), "bytes_accessed": float(nbytes)}


# -- the verdict --------------------------------------------------------------


def roofline_analyze(
    flops_per_exec: Optional[float],
    bytes_per_exec: Optional[float],
    device_ms_per_exec: Optional[float],
    busy_frac: Optional[float] = None,
    peaks: Optional[Dict[str, Any]] = None,
    dispatch_busy_threshold: float = 0.5,
    compute_peak_tflops: Optional[float] = None,
) -> Dict[str, Any]:
    """Classify one program's binding constraint from its measured roofline.

    Rules, in order:

    - no measured device time -> ``unmeasured`` (nothing else is computable);
    - the device was busy less than ``dispatch_busy_threshold`` of the
      profiled window -> ``dispatch-bound`` (the step path waits on the
      host; per-module utilization is still reported but is not the
      constraint);
    - otherwise, whichever of compute utilization and bandwidth
      utilization is higher is the wall being pushed: ``compute-bound`` or
      ``memory-bound``. With no cost available the verdict degrades to
      ``unknown``.

    Compute utilization is the FLOP rate over ``compute_peak_tflops``, the
    peak of the step's compute type (:func:`compute_peak`); left None it is
    the MFU (the bf16 peak), and then every key but the two it adds equals
    the JAX package's. Returns ``{mfu_pct, compute_util_pct,
    compute_peak_tflops, achieved_gbps, bandwidth_util_pct,
    arithmetic_intensity, ridge_intensity, verdict, peaks}``.
    """
    peaks = peaks or detect_peaks()
    peak_tflops, peak_gbps = peaks.get("peak_tflops"), peaks.get("peak_gbps")
    compute_peak_tflops = compute_peak_tflops or peak_tflops
    out: Dict[str, Any] = {
        "mfu_pct": None,
        "compute_util_pct": None,
        "compute_peak_tflops": compute_peak_tflops,
        "achieved_gbps": None,
        "bandwidth_util_pct": None,
        "arithmetic_intensity": None,
        "ridge_intensity": None,
        "verdict": "unmeasured",
        "peaks": peaks,
    }
    if peak_tflops and peak_gbps:
        out["ridge_intensity"] = round(peak_tflops * 1e12 / (peak_gbps * 1e9), 1)
    if not device_ms_per_exec or device_ms_per_exec <= 0:
        return out
    seconds = device_ms_per_exec / 1e3
    if flops_per_exec and bytes_per_exec:
        out["arithmetic_intensity"] = round(flops_per_exec / bytes_per_exec, 2)
    if flops_per_exec and peak_tflops:
        out["mfu_pct"] = round(flops_per_exec / seconds / (peak_tflops * 1e12) * 100.0, 3)
    if flops_per_exec and compute_peak_tflops:
        out["compute_util_pct"] = round(flops_per_exec / seconds / (compute_peak_tflops * 1e12) * 100.0, 3)
    if bytes_per_exec:
        out["achieved_gbps"] = round(bytes_per_exec / seconds / 1e9, 2)
        if peak_gbps:
            out["bandwidth_util_pct"] = round(out["achieved_gbps"] / peak_gbps * 100.0, 3)
    if busy_frac is not None and busy_frac < dispatch_busy_threshold:
        out["verdict"] = "dispatch-bound"
    elif out["compute_util_pct"] is None and out["bandwidth_util_pct"] is None:
        out["verdict"] = "unknown"
    elif (out["compute_util_pct"] or 0.0) >= (out["bandwidth_util_pct"] or 0.0):
        out["verdict"] = "compute-bound"
    else:
        out["verdict"] = "memory-bound"
    return out

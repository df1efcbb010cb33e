"""The port's device profiling (``sheeprl_tpu_torch/obs/prof``) on the CPU,
held against the JAX package's ``sheeprl_tpu/obs/prof``:

- ``roofline_analyze`` against JAX's over a grid of FLOPs, bytes, device
  ms, busy shares and peaks: equal dicts (pure arithmetic), every verdict;
- the trace parser on a Chrome trace carrying the modules, executions and
  op times of ``tests/test_obs/fixtures/make_mini_xplane.py``'s device
  fixture, against JAX's ``summarize_space`` on that xplane (per-module ms
  and executions to 1e-9 ms, phases, top ops), and on its host fixture;
  kernels replayed through ``cudaGraphLaunch`` inside a span, a launch from
  another thread, eager launches in a span and outside every range; a CPU
  ``torch.profiler`` session's raw events;
- ``StepProfiler``'s schedule against JAX's on the same ticks (start and
  finalize stubbed in both), ``max_captures``, and ``record_prof`` against
  JAX's on the same records;
- the byte and FLOP count of one eager call (``count_cost``), exact;
- a tiny PPO run through the port's CLI with a scheduled window lands a
  capture (``device_ms_per_step`` not null, the trace on disk), and
  ``metric.profiler=<dir>`` writes the whole run's trace;
- the harness builds DV3's, SAC's and PPO's real steps and counts them, the
  roofline report composes and resolves every family (``--dry-run``), and
  raw events of a PyTorch without ``activity_type`` (the card's 2.11) are
  classified by kind.
"""

from __future__ import annotations

import glob
import itertools
import json
import os

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch.obs.prof import capture, roofline, trace

FIXTURES = os.path.join(os.path.dirname(__file__), "test_obs", "fixtures")
MS_TOL = dict(rtol=0, atol=1e-9)


# -- roofline -------------------------------------------------------------------

PEAKS = (
    {"label": "H100", "peak_tflops": 989.4, "peak_gbps": 3350.0, "estimated": False},
    {"label": "CPU (8 cores, estimated)", "peak_tflops": 0.77, "peak_gbps": 64.0, "estimated": True},
    {"label": "unknown", "peak_tflops": None, "peak_gbps": None, "estimated": False},
)


@pytest.mark.parametrize("peaks", PEAKS, ids=lambda p: p["label"])
def test_roofline_analyze_matches_jax(peaks):
    from sheeprl_tpu.obs.prof.roofline import roofline_analyze as jax_analyze

    verdicts = set()
    grid = itertools.product((None, 0.0, 1e9, 8.46e11), (None, 1e8, 6.4e9), (None, 0.0, 0.5, 65.1),
                             (None, 0.3, 0.95))
    for flops, nbytes, ms, busy in grid:
        got = roofline.roofline_analyze(flops, nbytes, ms, busy, peaks=dict(peaks))
        want = jax_analyze(flops, nbytes, ms, busy, peaks=dict(peaks))
        # the port adds the compute type's share and peak: left to default they are the MFU and the bf16 peak
        assert {k: got[k] for k in want} == want, (flops, nbytes, ms, busy)
        assert set(got) - set(want) == {"compute_util_pct", "compute_peak_tflops"}
        assert (got["compute_util_pct"], got["compute_peak_tflops"]) == (got["mfu_pct"], peaks["peak_tflops"])
        verdicts.add(got["verdict"])
    if peaks["peak_tflops"]:
        assert verdicts == {"unmeasured", "dispatch-bound", "unknown", "compute-bound", "memory-bound"}


def test_detect_peaks_on_the_cpu_and_overrides():
    peaks = roofline.detect_peaks(device="cpu")
    assert peaks["platform"] == "cpu" and peaks["estimated"] and peaks["peak_gbps"] == 64.0
    full = roofline.detect_peaks(989.4, 3350.0, device="cpu")
    assert (full["peak_tflops"], full["peak_gbps"], full["estimated"]) == (989.4, 3350.0, False)
    assert dict(roofline.DEVICE_PEAKS)["H100"] == {"label": "H100", "peak_tflops": 989.4, "peak_gbps": 3350.0,
                                                   "peak_tflops_tf32": 494.7, "peak_tflops_f32": 66.9}


def test_the_verdict_weighs_the_flop_rate_against_the_step_compute_type():
    """An f32 step at 1.86 % of the bf16 peak and 17.2 % of the bandwidth
    (DV1's shares on the card) is memory-bound against the bf16 peak and
    compute-bound against the f32 SIMT peak (27.5 %): the MFU stays against
    the bf16 peak either way."""
    h100 = dict(dict(roofline.DEVICE_PEAKS)["H100"], estimated=False)
    assert [roofline.compute_peak(h100, t) for t in ("bf16", "tf32", "f32", None)] == [989.4, 494.7, 66.9, 989.4]
    assert roofline.compute_peak({"peak_tflops": 312.0}, "f32") == 312.0  # no entry for the type: the bf16 peak
    assert roofline.compute_dtype("bf16-mixed") == "bf16"
    assert roofline.compute_dtype("32-true") == ("tf32" if torch.backends.cuda.matmul.allow_tf32 else "f32")
    ms = 56.821
    flops = 0.01859 * 989.4e12 * ms / 1e3
    nbytes = 0.17199 * 3350e9 * ms / 1e3
    bf16 = roofline.roofline_analyze(flops, nbytes, ms, 0.99, peaks=h100)
    f32 = roofline.roofline_analyze(flops, nbytes, ms, 0.99, peaks=h100, compute_peak_tflops=66.9)
    assert bf16["verdict"] == "memory-bound" and f32["verdict"] == "compute-bound"
    assert bf16["mfu_pct"] == f32["mfu_pct"] == 1.859
    np.testing.assert_allclose(f32["compute_util_pct"], 1.859 * 989.4 / 66.9, rtol=1e-3)
    assert bf16["bandwidth_util_pct"] == f32["bandwidth_util_pct"] == 17.199


def test_count_cost_counts_a_products_flops_and_bytes():
    """A product ``[M, K] @ [K, N]``: 2·M·K·N FLOPs, and the bytes of its
    two inputs and its output once (the transpose is a view: no bytes)."""
    from sheeprl_tpu_torch.obs.perf import count_cost

    a, b = torch.randn(6, 5), torch.randn(7, 5)
    out, flops, nbytes = count_cost(lambda: a @ b.t())
    assert out.shape == (6, 7)
    assert flops == 2 * 6 * 5 * 7
    assert nbytes == 4 * (6 * 5 + 7 * 5 + 6 * 7)
    assert roofline.cost_of(lambda: a @ b.t()) == {"flops": float(flops), "bytes_accessed": float(nbytes)}


# -- the trace parser -------------------------------------------------------------


def _x(cat, name, ts, dur, pid, tid, corr=None):
    event = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": pid, "tid": tid}
    if corr is not None:
        event["args"] = {"correlation": corr}
    return event


def _write(path, events) -> str:
    with open(path, "w") as f:
        json.dump({"traceEvents": [{"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "gpu"}}] + events},
                  f)
    return str(path)


def mini_device_trace(path) -> str:
    """``mini.xplane.pb``'s device plane as a port trace: three replays of
    ``step:train_step`` (a graph launch each), each 4 ms of device time at
    0, 5 and 10 ms; the kernels' self-times fusion.1 3 ms, fusion.2 1 ms,
    copy.3 0.5 ms (µs, host pid 1 thread 1, device pid 0 stream 7)."""
    events = []
    kernels = {1: [("fusion.1", 0, 1000), ("fusion.1", 3000, 1000)],
               2: [("fusion.1", 5000, 500), ("fusion.2", 8500, 500)],
               3: [("fusion.1", 10000, 500), ("fusion.2", 13000, 500), ("copy.3", 13500, 500)]}
    for corr, start in ((1, 0), (2, 5000), (3, 10000)):
        events.append(_x("user_annotation", "step:train_step", start, 4000, 1, 1))
        events.append(_x("cuda_runtime", "cudaGraphLaunch", start + 10, 5, 1, 1, corr))
        events += [_x("kernel", name, ts, dur, 0, 7, corr) for name, ts, dur in kernels[corr]]
    return _write(path, events)


def test_the_parser_matches_jax_on_the_mini_device_fixture(tmp_path):
    from sheeprl_tpu.obs.prof.xplane import load_xspace, summarize_space

    want = summarize_space(load_xspace(os.path.join(FIXTURES, "mini.xplane.pb")))
    got = trace.summarize(mini_device_trace(tmp_path / "trace.json"))
    assert got["source"] == want["source"] == "device"
    assert set(got["modules"]) == set(want["modules"]) == {"train_step"}
    for name, w in want["modules"].items():
        g = got["modules"][name]
        assert (g["execs"], g["phase"]) == (w["execs"], w["phase"])
        for key in ("total_ms", "ms_per_exec"):
            np.testing.assert_allclose(g[key], w[key], **MS_TOL, err_msg=key)
        assert (g["replays"], g["ms_per_replay"]) == (3, g["ms_per_exec"])
    assert got["train_module"] == want["train_module"]
    for key in ("window_ms", "busy_ms", "busy_frac"):
        assert got[key] == want[key], key
    assert set(got["top_ops"]) == set(want["top_ops"])
    for name, ms in want["top_ops"].items():
        np.testing.assert_allclose(got["top_ops"][name], ms, **MS_TOL, err_msg=name)
    assert got["kernel_counts"] == {"fusion.1": 4, "fusion.2": 2, "copy.3": 1}
    assert (got["comms_ms_total"], got["comms_ms_by_kind"]) == (0.0, {})
    with_steps = trace.summarize(str(tmp_path / "trace.json"), n_steps=3)
    np.testing.assert_allclose(with_steps["modules_us_per_step"], 4000.0, **MS_TOL)


def test_the_parser_matches_jax_on_the_mini_host_fixture(tmp_path):
    """The host fallback: nested duplicate step ranges are one execution."""
    from sheeprl_tpu.obs.prof.xplane import load_xspace, summarize_space

    want = summarize_space(load_xspace(os.path.join(FIXTURES, "mini_host.xplane.pb")))
    events = []
    for start in (0, 3000):
        events += [_x("user_annotation", "step:shmapped", start, 2000, 1, 1),
                   _x("user_annotation", "step:shmapped", start + 50, 1900, 1, 1),
                   _x("cpu_op", "aten::mm", start + 100, 1800, 1, 1)]
    got = trace.summarize(_write(tmp_path / "host.json", events))
    assert got["source"] == want["source"] == "host"
    assert {k: (m["execs"], m["phase"]) for k, m in got["modules"].items()} == {
        k: (m["execs"], m["phase"]) for k, m in want["modules"].items()}
    for key in ("total_ms", "ms_per_exec"):
        np.testing.assert_allclose(got["modules"]["shmapped"][key], want["modules"]["shmapped"][key], **MS_TOL)
    assert (got["train_module"], got["window_ms"], got["busy_ms"], got["busy_frac"]) == (
        want["train_module"], want["window_ms"], want["busy_ms"], want["busy_frac"])
    assert got["top_ops"] == want["top_ops"] == {}


def test_graph_replays_inside_a_span_are_attributed_through_the_correlation(tmp_path):
    """In a span ``Time/train_time``: two eager warm-up calls of
    ``step:train_step`` (their backward kernels launched from another
    thread, which opened no range) and two replays through
    ``cudaGraphLaunch``; an eager launch in the span outside any step; one
    launch outside every range."""
    ev = [_x("user_annotation", "Time/train_time", 0, 40000, 1, 1)]
    corr = itertools.count(1)
    for start, replay in ((1000, False), (9000, False), (17000, True), (25000, True)):
        ev.append(_x("user_annotation", "step:train_step", start, 6000, 1, 1))
        if replay:
            c = next(corr)
            ev.append(_x("cuda_runtime", "cudaGraphLaunch", start + 10, 5, 1, 1, c))
            ev += [_x("kernel", "gemm", start + 100, 1000, 0, 7, c), _x("kernel", "gates", start + 1100, 900, 0, 7, c)]
        else:
            c1, c2 = next(corr), next(corr)
            ev += [_x("cuda_runtime", "cudaLaunchKernel", start + 10, 5, 1, 1, c1),
                   _x("kernel", "gemm", start + 100, 1000, 0, 7, c1),
                   # autograd's backward thread launches while the step's range is open on the loop thread
                   _x("cuda_runtime", "cudaLaunchKernel", start + 3000, 5, 1, 2, c2),
                   _x("kernel", "gemm_bwd", start + 3100, 2900, 0, 7, c2)]
    c = next(corr)
    ev += [_x("cuda_runtime", "cudaLaunchKernel", 33000, 5, 1, 1, c), _x("kernel", "copy", 33100, 400, 0, 7, c)]
    c = next(corr)
    ev += [_x("cuda_runtime", "cudaMemcpyAsync", 45000, 5, 1, 1, c), _x("gpu_memcpy", "Memcpy HtoD", 45100, 200, 0, 8, c)]
    got = trace.summarize(_write(tmp_path / "graph.json", ev))
    mods = got["modules"]
    assert set(mods) == {"train_step", "Time/train_time", "eager"}
    step = mods["train_step"]
    assert (step["execs"], step["replays"], step["phase"]) == (4, 2, "train")
    np.testing.assert_allclose(step["ms_per_replay"], 1.9, **MS_TOL)
    np.testing.assert_allclose(step["ms_per_exec"], (5.9 * 2 + 1.9 * 2) / 4, **MS_TOL)
    assert (mods["Time/train_time"]["execs"], mods["eager"]["execs"]) == (1, 1)
    assert got["train_module"] == "train_step"
    assert got["kernel_counts"]["gemm"] == 4 and got["kernel_counts"]["Memcpy HtoD"] == 1
    record = capture.analyze_trace(str(tmp_path / "graph.json"), flops_per_step=2e9, bytes_per_step=1e8,
                                   dispatches_per_step=2, peaks=dict(PEAKS[0]))
    assert record["device_ms_per_step"] == round(1.9 * 2, 3) and record["train_execs"] == 4
    assert record["roofline_verdict"] in ("compute-bound", "memory-bound", "dispatch-bound")


def test_a_cpu_profiler_sessions_raw_events_give_the_steps():
    """A real ``torch.profiler`` session on the CPU: the port's
    ``CapturedStep`` calls (eager on the CPU) are the modules, read from the
    session's raw events and from its Chrome trace alike."""
    from sheeprl_tpu_torch.train.graphs import CapturedStep

    a = torch.randn(64, 64)
    step = CapturedStep(lambda: (a @ a).sum(), "cpu", train=True)
    act = CapturedStep(lambda: a.sum(), "cpu", name="act")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            step()
            act()
    got = trace.summarize_events(trace.events_from_profiler(prof))
    assert got["source"] == "host"
    assert {k: (m["execs"], m["phase"]) for k, m in got["modules"].items()} == {
        "train_step": (3, "train"), "act": (3, "act")}
    assert got["train_module"] == "train_step"


# -- the capture scheduler --------------------------------------------------------


class _Tel:
    run_dir = "/nonexistent"


def _stub(profiler, started):
    def _start(policy_step, world_size):
        started.append(int(policy_step))
        profiler._active = {"step": policy_step}

    def _finalize(wait=False):
        if profiler._active is not None:
            profiler._active = None
            profiler.captures += 1

    profiler._start, profiler._finalize = _start, _finalize


@pytest.mark.parametrize("every,max_captures", [(100, 3), (250, 4), (1, 2)])
def test_the_step_profiler_schedules_as_jax(every, max_captures):
    from sheeprl_tpu.obs.prof.capture import StepProfiler as JaxStepProfiler

    ticks = [0, 50, 100, 100, 150, 260, 270, 400, 410, 800, 805, 1600, 1610, 1700, 1800, 2000, 2001]
    pcfg = {"every_n_steps": every, "window_s": 5.0, "max_captures": max_captures}
    runs = []
    for cls in (capture.StepProfiler, JaxStepProfiler):
        profiler, started = cls(pcfg, _Tel()), []
        _stub(profiler, started)
        for t in ticks:
            profiler.tick(t, world_size=1)
        runs.append((started, profiler.captures, profiler._next_at))
    assert runs[0] == runs[1]
    assert runs[0][1] <= max_captures


def test_record_prof_keeps_the_measured_capture_as_jax():
    from sheeprl_tpu.obs.telemetry import Telemetry as JaxTelemetry

    from sheeprl_tpu_torch.obs.telemetry import Telemetry

    records = [{"step": 100, "device_ms_per_step": None}, {"step": 200, "device_ms_per_step": 4.0},
               {"step": 300, "device_ms_per_step": None}, {"step": 150, "device_ms_per_step": 3.0},
               {"step": 400, "device_ms_per_step": 5.0}]
    lasts = []
    for cls in (Telemetry, JaxTelemetry):
        tel, seen = cls({}), []
        for r in records:
            tel.record_prof(dict(r))
            seen.append(tel._prof_last)
        lasts.append(seen)
    assert lasts[0] == lasts[1]
    assert [s["step"] for s in lasts[0]] == [100, 200, 200, 200, 400]


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_a_cards_window_without_device_events_is_a_failed_capture(tmp_path, monkeypatch, device):
    """The host fallback profiles a CPU run; a window on a card with no
    device event (host ranges only) is counted failed, with its reason, and
    leaves the device time, the MFU and the verdict null: no host time is
    read as the card's."""
    from sheeprl_tpu_torch.obs.telemetry import Telemetry

    path = _write(tmp_path / "host.json", [
        ev for start in (0, 3000) for ev in (_x("user_annotation", "step:train_step", start, 2000, 1, 1),
                                             _x("cpu_op", "aten::mm", start + 100, 1800, 1, 1))])
    telemetry = Telemetry({}, device=device)
    telemetry.run_dir = str(tmp_path / "run")
    telemetry.prof = capture.StepProfiler({"every_n_steps": 1}, telemetry)
    opened = []
    monkeypatch.setattr(capture, "open_window", lambda out_dir, seconds, on_done: opened.append(on_done))
    telemetry.prof.tick(1)
    window = type("Window", (), {"costs_s": {}, "launches": {}})()
    record = opened[0](trace.load_trace(path), window)
    summary = telemetry.summary()
    if device == "cuda":
        assert record is None and (telemetry.prof.captures, telemetry.prof.failed) == (0, 1)
        assert summary["device_ms_per_step"] is summary["mfu_device_pct"] is summary["roofline_verdict"] is None
        assert summary["prof_captures"] == 0 and summary["prof"]["failed"] == 1
        assert summary["prof"]["last_failure"].startswith("NoDeviceEvents")
        with pytest.raises(capture.NoDeviceEvents):
            capture.analyze_trace(path, device="cuda:0")
    else:
        assert record["source"] == "host" and (telemetry.prof.captures, telemetry.prof.failed) == (1, 0)
        np.testing.assert_allclose(summary["device_ms_per_step"], 2.0, **MS_TOL)
        assert summary["prof"]["source"] == "host" and summary["prof"]["failed"] == 0


def test_one_window_at_a_time_and_the_slot_is_released(tmp_path):
    done = []
    window = capture.open_window(str(tmp_path / "w"), 0.0, on_done=lambda events, w: done.append(len(events or [])))
    assert window is not None and not capture.try_begin_capture()
    assert capture.open_window(str(tmp_path / "x"), 0.0) is None
    with torch.profiler.record_function("step:train_step"):
        (torch.randn(8, 8) @ torch.randn(8, 8)).sum()
    assert window.stop() and not window.stop()
    window.wait()
    # the window records the user's ranges and the card's activity, not every operator
    assert done == [1] and os.path.getsize(tmp_path / "w" / "trace.json") > 0
    assert capture.try_begin_capture()
    capture.end_capture()


# -- a run through the CLI --------------------------------------------------------

PPO_RUN = ["exp=ppo", "env=dummy", "cnn_keys.encoder=[rgb]", "mlp_keys.encoder=[]", "env.num_envs=2",
           "env.sync_env=True", "fabric.accelerator=cpu", "buffer.memmap=False", "algo.rollout_steps=8",
           "per_rank_batch_size=8", "algo.update_epochs=1", "env.capture_video=False", "algo.run_test=False",
           "checkpoint.every=100000"]


def test_a_profiled_ppo_run_lands_its_captures(tmp_path, monkeypatch):
    from sheeprl_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    cli.run(PPO_RUN + ["total_steps=64", "metric.log_every=16", "metric=telemetry",
                       "metric.telemetry.profile.every_n_steps=16", "metric.telemetry.profile.window_s=0",
                       "metric.telemetry.learn.enabled=False", f"root_dir={tmp_path}/logs", "run_name=p"])
    (run_dir,) = glob.glob(str(tmp_path / "logs" / "p" / "version_0"))
    summary = json.load(open(os.path.join(run_dir, "telemetry.json")))
    assert summary["prof_captures"] >= 1 and summary["prof"]["failed"] == 0
    assert summary["device_ms_per_step"] is not None and summary["device_ms_per_step"] > 0
    assert summary["roofline_verdict"] in ("compute-bound", "memory-bound", "dispatch-bound")
    assert summary["bytes_per_train_step"] > 0 and summary["prof"]["train_module"] == "train_step"
    assert glob.glob(os.path.join(run_dir, "telemetry", "prof", "step_*", "trace.json"))
    assert glob.glob(os.path.join(run_dir, "telemetry", "prof", "capture_*.json"))

    cli.run(PPO_RUN + ["dry_run=True", f"metric.profiler={tmp_path}/traces", f"root_dir={tmp_path}/logs",
                       "run_name=q"])
    got = trace.summarize(str(tmp_path / "traces" / "trace.json"))
    assert got["source"] == "host" and got["modules"]["train_step"]["execs"] >= 1


# -- the harness, the report, a PyTorch without activity_type ---------------------


@pytest.mark.parametrize("family", ["dv3", "sac", "ppo"])
def test_the_harness_builds_a_familys_real_step_and_counts_it(family):
    from sheeprl_tpu_torch.obs.prof.harness import build_harness

    harness = build_harness(family, tiny=True, device="cpu")
    cost = harness.cost()
    assert cost["flops"] > 0 and cost["bytes_accessed"] > cost["flops"] / 1e3
    harness.warm_up()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        harness.run(1)
    got = trace.summarize_events(trace.events_from_profiler(prof))
    assert got["train_module"] == "train_step"
    assert got["modules"]["train_step"]["execs"] == harness.calls_per_run


def test_the_roofline_report_composes_and_resolves_every_family(capsys):
    from sheeprl_tpu_torch.tools import roofline_report

    families = ["dv1", "dv2", "dv3", "p2e_dv1", "p2e_dv2", "p2e_dv3", "sac", "ppo"]
    assert roofline_report.main(["--dry-run", "--families", *families]) == 0
    assert "8 families compose and resolve" in capsys.readouterr().out


class _RawEvent:
    """A raw event of a PyTorch whose ``_KinetoEvent`` has no ``activity_type``."""

    def __init__(self, name, device, start_ns, dur_ns, corr, annotation=False, tid=1):
        self._v = (name, device, start_ns, dur_ns, corr, annotation, tid)

    def name(self):
        return self._v[0]

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self._v[1] else DeviceType.CPU

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]

    def start_thread_id(self):
        return self._v[6]

    def device_index(self):
        return 0

    def device_resource_id(self):
        return 7


def test_raw_events_without_activity_type_are_classified_by_kind():
    from types import SimpleNamespace

    raw = [_RawEvent("step:train_step", False, 0, 4_000_000, 1, annotation=True),
           _RawEvent("cudaGraphLaunch", False, 10_000, 5_000, 2),
           _RawEvent("aten::mm", False, 20_000, 5_000, 3),
           _RawEvent("step:train_step", True, 0, 4_000_000, 4, annotation=True),
           _RawEvent("gemm", True, 100_000, 1_000_000, 2),
           _RawEvent("Memcpy HtoD (Pageable -> Device)", True, 2_000_000, 500_000, 2)]
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: raw)))
    events = trace.events_from_profiler(prof)
    # an operator's own record attributes nothing: it is skipped
    assert [e[0] for e in events] == ["user_annotation", "cuda_runtime", "gpu_user_annotation", "kernel", "gpu_memcpy"]
    got = trace.summarize_events(events)
    assert got["modules"]["train_step"]["replays"] == 1
    np.testing.assert_allclose(got["modules"]["train_step"]["ms_per_replay"], 2.4, **MS_TOL)
    assert trace.device_us_by_name(events) == {"gemm": 1000.0, "Memcpy HtoD (Pageable -> Device)": 500.0}
    # the tools' quick read: the device's work alone, its ranges left out
    assert trace.device_durations(prof) == [("gemm", 1000.0), ("Memcpy HtoD (Pageable -> Device)", 500.0)]
    assert trace.device_us_by_name(prof) == trace.device_us_by_name(events)

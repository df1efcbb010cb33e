"""The port's run telemetry end to end through its CLI, on the CPU:

- a PPO run with ``metric=telemetry`` through each package's CLI at one
  small config: both ``telemetry.json`` files have the same key set (the
  port's plus ``graph_replays``) and the same step, checkpoint and guard
  counts, and both traces the same (name, phase) pairs;
- a crashed run's ``telemetry.json`` records the crash and the exception;
- a run without telemetry writes no telemetry file and starts no telemetry
  thread, and leaves no histogram, tracer or counters installed;
- a NaN loss writes the flight recorder's dump;
- the profiler's and the learning-health plane's knobs run for one
  entrypoint of each family and write their output: ``metric.profiler``'s
  trace, a scheduled capture (``prof_captures``), the flight recorder's
  profiler window, the ``learn`` keys.
"""

from __future__ import annotations

import glob
import json
import os
import threading

import pytest
from jax_cli_switches import run_jax_cli
from test_torch_isolation import TINY_DV1, TINY_P2E, TINY_RUN, TINY_RUN_DV3
from test_torch_ppo import restore_prng_impl  # noqa: F401  (a module fixture: the JAX CLI's Fabric)

from sheeprl_tpu_torch import cli

TELEMETRY = ["metric=telemetry", "metric.telemetry.learn.enabled=False"]
PPO_TINY = ["exp=ppo", "env=dummy", "cnn_keys.encoder=[rgb]", "mlp_keys.encoder=[]", "env.num_envs=2",
            "env.sync_env=True", "dry_run=True", "fabric.accelerator=cpu", "buffer.memmap=False",
            "algo.rollout_steps=8", "per_rank_batch_size=8", "algo.update_epochs=1", "env.capture_video=False"]


def _run_dir(root) -> str:
    (path,) = glob.glob(os.path.join(str(root), "*", "version_0"))
    return path


def _pairs(trace: str) -> set:
    with open(trace) as f:
        events = [json.loads(line) for line in f]
    return {(e["name"], e["cat"]) for e in events if e.get("ph") == "X"}


def test_a_ppo_run_has_the_jax_runs_keys_counts_and_phases(tmp_path, monkeypatch):

    monkeypatch.chdir(tmp_path)
    cli.run(PPO_TINY + TELEMETRY + [f"root_dir={tmp_path}/port", "run_name=r"])
    run_jax_cli(PPO_TINY + TELEMETRY + [f"root_dir={tmp_path}/jax", "run_name=r"])
    dirs = {side: _run_dir(tmp_path / side) for side in ("port", "jax")}
    ours, theirs = (json.load(open(os.path.join(dirs[s], "telemetry.json"))) for s in ("port", "jax"))
    assert set(ours) == set(theirs) | {"graph_replays"}
    for key in ("policy_steps", "train_steps", "ckpt_saves", "nonfinite_metrics", "crashed", "stalls", "act_dispatches",
                "rollout_bursts"):
        assert ours[key] == theirs[key], key
    assert ours["policy_steps"] == 16 and ours["ckpt_saves"] == 1 and ours["crashed"] is False
    assert ours["bytes_staged_h2d"] > 0 and ours["flops_per_train_step"] > 0 and 0 <= ours["mfu"] < 100
    # the CPU run replays no graph and the poller samples no card
    assert (ours["recompiles"], ours["graph_replays"], ours["peak_hbm_bytes"], ours["hbm_bytes_limit"]) == (0, 0, 0, 0)
    for key in ("device_ms_per_step", "mfu_device_pct", "roofline_verdict", "grad_norm_p95", "update_ratio_p50"):
        assert ours[key] is None and theirs[key] is None
    traces = {s: os.path.join(dirs[s], "telemetry", "trace.jsonl") for s in dirs}
    assert _pairs(traces["port"]) == _pairs(traces["jax"])
    assert {("Time/train_time", "train"), ("Time/checkpoint_time", "checkpoint")} <= _pairs(traces["port"])
    live = json.load(open(os.path.join(dirs["port"], "telemetry", "live.json")))
    assert live["policy_steps"] == 16 and "rolling" in live and "watchdog_beat_age_s" in live


def test_a_crashed_run_records_the_crash(tmp_path, monkeypatch):
    from sheeprl_tpu_torch.algos.ppo import ppo

    def boom(*args, **kwargs):
        raise RuntimeError("boom in the test episode")

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(ppo, "test", boom)
    with pytest.raises(RuntimeError, match="boom"):
        cli.run(PPO_TINY + TELEMETRY + [f"root_dir={tmp_path}/logs", "run_name=crash", "algo.run_test=True"])
    summary = json.load(open(os.path.join(_run_dir(tmp_path / "logs"), "telemetry.json")))
    assert summary["crashed"] is True
    assert summary["exception"] == "RuntimeError: boom in the test episode"
    assert summary["ckpt_saves"] == 1  # the counters up to the crash


def test_a_run_without_telemetry_writes_nothing_and_starts_no_thread(tmp_path, monkeypatch):
    from sheeprl_tpu_torch.obs import counters, hist
    from sheeprl_tpu_torch.obs.dist import staleness
    from sheeprl_tpu_torch.obs.spans import get_tracer
    from sheeprl_tpu_torch.obs.telemetry import get_telemetry

    started = []
    real_start = threading.Thread.start

    def start(self):
        started.append(self.name)
        return real_start(self)

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(threading.Thread, "start", start)
    seen = []
    from sheeprl_tpu_torch.obs import perf

    real_log = perf.log_sps_metrics

    def log_sps_metrics(*args, **kwargs):  # mid-run: nothing of the telemetry is installed
        seen.append((get_telemetry(), get_tracer(), hist.installed(), counters.installed(), staleness.installed()))
        return real_log(*args, **kwargs)

    from sheeprl_tpu_torch.algos.ppo import ppo

    monkeypatch.setattr(ppo, "log_sps_metrics", log_sps_metrics)
    cli.run(PPO_TINY + [f"root_dir={tmp_path}/logs", "run_name=off"])
    run_dir = _run_dir(tmp_path / "logs")
    assert not os.path.exists(os.path.join(run_dir, "telemetry.json"))
    assert not os.path.exists(os.path.join(run_dir, "telemetry"))
    assert seen == [(None, None, None, None, None)]
    assert not [name for name in started if name.startswith(("obs-", "policy-publisher"))], started


def test_a_nan_loss_writes_a_flight_dump(tmp_path, monkeypatch):
    from sheeprl_tpu_torch.algos.ppo import ppo

    real = ppo.policy_loss
    monkeypatch.setattr(ppo, "policy_loss", lambda *a, **k: real(*a, **k) * float("nan"))
    monkeypatch.chdir(tmp_path)
    with pytest.warns(RuntimeWarning, match="non-finite"):
        cli.run(PPO_TINY + TELEMETRY + [f"root_dir={tmp_path}/logs", "run_name=nan"])
    run_dir = _run_dir(tmp_path / "logs")
    summary = json.load(open(os.path.join(run_dir, "telemetry.json")))
    assert summary["nonfinite_metrics"] >= 1 and summary["flight_dumps"] == 1
    (dump,) = glob.glob(os.path.join(run_dir, "telemetry", "flight_nonfinite_*.json"))
    doc = json.load(open(dump))
    assert doc["reason"] == "nonfinite" and doc["detail"]["metric"].startswith("Loss/")
    assert doc["events"] and doc["context"]["counters"]["nonfinite_metrics"] >= 1


FAMILIES = {
    "dv1": TINY_DV1 + ["exp=dreamer_v1"],
    "dv2": TINY_RUN,
    "dv3": TINY_RUN_DV3,
    "p2e": TINY_P2E + ["exp=p2e_dv3_exploration"],
    "sac": ["exp=sac", "env=gym", "env.id=Pendulum-v1", "env.sync_env=True", "env.capture_video=False",
            "mlp_keys.encoder=[state]", "dry_run=True"],
    "ppo": PPO_TINY,
    "decoupled": ["exp=sac_decoupled", "fabric.devices=auto", "env.id=Pendulum-v1", "dry_run=True",
                  "env.capture_video=False"],
}
#: each knob, and what its run must leave: "trace" (metric.profiler's Chrome trace), "capture" (a parsed
#: scheduled window), "flight" (a flight dump's profiler window, parsed), "learn" (the sentinel's keys)
KNOBS = {
    "6h-b: metric.profiler": (["metric.profiler=true"], "trace"),
    "6h-b: metric.telemetry.profile": (
        ["metric=telemetry", "metric.telemetry.profile.every_n_steps=1", "metric.telemetry.profile.window_s=0"],
        "capture",
    ),
    # a slow-span trigger armed from the first observation at any duration fires the flight recorder in every run
    "6h-b: metric.telemetry.flight.profiler_capture_s": (
        ["metric=telemetry", "metric.telemetry.flight.profiler_capture_s=0.05",
         "metric.telemetry.flight.slow_span_warmup=0", "metric.telemetry.flight.slow_span_factor=1e-9",
         "metric.telemetry.flight.slow_span_min_ms=0", "metric.telemetry.flight.min_interval_s=3600"],
        "flight",
    ),
    "6h-c: metric.telemetry.learn": (["metric=telemetry"], "learn"),
}


@pytest.mark.parametrize("knob", sorted(KNOBS))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_the_knobs_of_later_items_raise_for_every_family(tmp_path, monkeypatch, family, knob):
    """Each knob runs (the name is kept from when they raised): a dry run of
    one entrypoint of each family writes the knob's output."""
    knob_args, output = KNOBS[knob]
    monkeypatch.chdir(tmp_path)
    args = [a for a in FAMILIES[family] if not a.startswith(("root_dir=", "fabric.accelerator=", "metric.log_level="))]
    cli.run(args + knob_args + [f"root_dir={tmp_path}/logs", "run_name=knob", "fabric.accelerator=cpu",
                                "metric.log_level=1"])
    if output == "trace":
        assert os.path.getsize(tmp_path / "logs" / "knob" / "torch_traces" / "trace.json") > 0
        return
    run_dir = _run_dir(tmp_path / "logs")
    summary = json.load(open(os.path.join(run_dir, "telemetry.json")))
    if output == "capture":
        assert summary["prof_captures"] >= 1 and summary["prof"]["failed"] == 0
        assert glob.glob(os.path.join(run_dir, "telemetry", "prof", "step_*", "trace.json"))
    elif output == "flight":
        (summary_file,) = glob.glob(os.path.join(run_dir, "telemetry", "flight_*_trace_summary.json"))
        assert json.load(open(summary_file))["source"] == "host"
        assert glob.glob(os.path.join(run_dir, "telemetry", "flight_*_trace", "trace.json"))
    else:
        assert summary["learn_probe_fetches"] >= 1 and summary["learn"]["bursts_observed"] >= 1
        assert summary["grad_norm_p95"] is not None and summary["learn"]["probes"]["learn/grad_norm"]["n"] >= 1

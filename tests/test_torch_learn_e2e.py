"""The divergence story end to end through both packages' CLIs, on the CPU:
a tiny seeded SAC Pendulum run of each package with an injected learning
rate spike (``metric.telemetry.learn.inject_lr_spike_*``: every optimizer's
rate × 1e6 once, at update 180: the JAX package's acceptance run,
``tests/test_obs/test_learn_e2e.py``, acting one step a dispatch, so that
each gradient step's probes are graded before the next) fires a ``critical`` event (a sustained
grad-norm explosion) timestamped before the run's first non-finite value and
a ``learn_divergence`` flight dump; the same run without the spike stays
free of critical events; and ``run_report --compare`` (the port's
``sheeprl_tpu_torch.tools.run_report``) flags the spike run against the
clean one, for the JAX run's directory as for the port's (one
``telemetry.json`` schema).
"""

from __future__ import annotations

import glob
import json
import os

import pytest
from jax_cli_switches import run_jax_cli

from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.tools import run_report

#: the update the spike fires at: past the sentinel's 20-sample warm-up (training starts at update 32)
SPIKE_AT = 180


def _sac_args(root, run_name, extra=()):
    # every trigger dumps (no 30 s rate limit): a slow-span dump early in the run must not hold back the
    # learn_divergence one
    return ["exp=sac", "env=gym", "env.id=Pendulum-v1", "env.sync_env=True", "env.num_envs=2",
            "env.capture_video=False", "seed=5", "fabric.accelerator=cpu", "fabric.devices=1", "total_steps=512",
            "metric.telemetry.flight.min_interval_s=0",
            "algo.learning_starts=64", "algo.hidden_size=8", "algo.run_test=False", "per_rank_batch_size=16",
            "buffer.size=1024", "buffer.memmap=False", "checkpoint.every=0", "checkpoint.save_last=True",
            "metric.log_level=1", "metric.log_every=100", "metric.telemetry.enabled=true",
            "metric.telemetry.trace=false", f"root_dir={root}/logs", f"run_name={run_name}", *extra]


SPIKE = (f"metric.telemetry.learn.inject_lr_spike_at={SPIKE_AT}", "metric.telemetry.learn.inject_lr_spike_factor=1000000")


def _run_dir(root, run_name) -> str:
    (path,) = glob.glob(f"{root}/logs/**/{run_name}/**/telemetry.json", recursive=True)
    return os.path.dirname(path)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_an_lr_spike_fires_a_critical_before_the_first_nonfinite(tmp_path, monkeypatch, package):
    monkeypatch.chdir(tmp_path)
    run = cli.run if package == "port" else run_jax_cli
    run(_sac_args(tmp_path, "spike", SPIKE))
    run(_sac_args(tmp_path, "clean"))
    spike_dir, clean_dir = _run_dir(tmp_path, "spike"), _run_dir(tmp_path, "clean")
    spike = json.load(open(os.path.join(spike_dir, "telemetry.json")))
    clean = json.load(open(os.path.join(clean_dir, "telemetry.json")))
    learn = spike["learn"]
    assert spike["learn_criticals"] >= 1 and learn["first_nonfinite_ts"] is not None, learn
    first = next(e for e in learn["events"] if e["severity"] == "critical")
    assert first["reason"] == "sustained_explosion" and first["ts_unix"] <= learn["first_nonfinite_ts"]
    assert glob.glob(os.path.join(spike_dir, "telemetry", "flight_learn_divergence_*.json"))
    assert clean["learn_criticals"] == 0 and clean["learn_probe_fetches"] > 0 and clean["grad_norm_p95"] is not None

    assert run_report.main([spike_dir]) == 0
    report = open(os.path.join(spike_dir, "report.md")).read()
    assert "CRITICAL" in report and "sustained_explosion" in report and "flight_learn_divergence_" in report
    assert run_report.main([spike_dir, "--compare", clean_dir]) == 1
    assert run_report.main([clean_dir, "--compare", clean_dir]) == 0

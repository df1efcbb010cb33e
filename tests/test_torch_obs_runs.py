"""``metric=telemetry`` on an entrypoint of each family through the port's
CLI, on the CPU: the run writes ``telemetry.json`` with the JAX package's
key set (the port adds ``graph_replays``), ``telemetry/trace.jsonl`` and
``telemetry/live.json``, and its counters agree with the loop's own. The
decoupled family's run is in ``test_torch_obs_plane.py``.
"""

from __future__ import annotations

import json
import os

import pytest
from test_torch_isolation import TINY_DV1, TINY_P2E, TINY_RUN, TINY_RUN_DV3

from sheeprl_tpu_torch import cli

TELEMETRY = ["metric=telemetry", "metric.telemetry.learn.enabled=False", "metric.telemetry.live_interval_s=0.2"]
FAMILIES = {
    "dv1": TINY_DV1 + ["exp=dreamer_v1"],
    "dv2": TINY_RUN,
    "dv3": TINY_RUN_DV3,
    "p2e_dv3": TINY_P2E + ["exp=p2e_dv3_exploration"],
    "sac": ["exp=sac", "env=gym", "env.id=Pendulum-v1", "env.sync_env=True", "env.capture_video=False",
            "env.num_envs=2", "mlp_keys.encoder=[state]", "buffer.memmap=False", "algo.hidden_size=8",
            "per_rank_batch_size=4", "total_steps=24", "algo.learning_starts=8", "run_name=sac"],
    "ppo": ["exp=ppo", "env=dummy", "cnn_keys.encoder=[rgb]", "mlp_keys.encoder=[]", "env.num_envs=2",
            "env.sync_env=True", "dry_run=True", "buffer.memmap=False", "algo.rollout_steps=8",
            "per_rank_batch_size=8", "algo.update_epochs=1", "env.capture_video=False", "run_name=ppo"],
}


def _jax_keys() -> set:
    """The keys of a JAX run's ``telemetry.json`` with the profiler and the
    learning-health plane off (a finalized run adds ``crashed``)."""
    from sheeprl_tpu.obs.telemetry import Telemetry

    return (set(Telemetry({"learn": {"enabled": False}}).summary()) | {"crashed"}) - {"sources"}


def _telemetry_files(log_dir: str) -> dict:
    summary = json.load(open(os.path.join(log_dir, "telemetry.json")))
    live = json.load(open(os.path.join(log_dir, "telemetry", "live.json")))
    with open(os.path.join(log_dir, "telemetry", "trace.jsonl")) as f:
        events = [json.loads(line) for line in f]
    return {"summary": summary, "live": live, "events": events}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_each_family_writes_the_jax_telemetry(tmp_path, monkeypatch, family):
    monkeypatch.chdir(tmp_path)
    args = [a for a in FAMILIES[family] if not a.startswith(("root_dir=", "fabric.accelerator="))]
    result = cli.run(args + TELEMETRY + [f"root_dir={tmp_path}/logs", "fabric.accelerator=cpu"])
    files = _telemetry_files(result["log_dir"])
    summary = files["summary"]
    assert set(summary) - {"sources"} == _jax_keys() | {"graph_replays", "trace_file"}
    assert summary["crashed"] is False and summary["trace_file"].endswith("trace.jsonl")
    assert summary["policy_steps"] == result["policy_steps"]
    assert summary["ckpt_saves"] == (1 if result["checkpoint"] else 0)
    # on the CPU every step runs eagerly: nothing is captured or replayed
    graphs = result["graphs"]
    assert summary["recompiles"] == sum(g["captured"] for g in graphs.values()) == 0
    assert summary["graph_replays"] == sum(g["replays"] for g in graphs.values()) == 0
    phases = {(e["name"], e["cat"]) for e in files["events"] if e.get("ph") == "X"}
    assert ("Time/env_interaction_time", "env") in phases
    assert {e["name"] for e in files["events"] if e.get("ph") == "M"} >= {"clock_sync", "process_name"}
    assert files["live"]["policy_steps"] == summary["policy_steps"] and "rolling" in files["live"]
    if result.get("gradient_steps"):
        assert ("Time/train_time", "train") in phases and summary["flops_per_train_step"] > 0
    assert summary["train_bursts"] == result.get("train_bursts", 0)

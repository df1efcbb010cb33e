"""The run telemetry of the decoupled plane with player processes, through
the port's CLI on the CPU: a 2-player ``sac_decoupled`` run with
``metric=telemetry`` merges its players' counter snapshots (the slabs, the
policy versions, their env pools' steps), carries the staleness section and
the players' watchdog beats, and publishes every version to
``<log_dir>/policy/`` (through writer processes: every version lands, in
order, and a failed write is raised by a later publish); a gateway with
that directory as ``serve.poll_root`` swaps to a version the live run
publishes.
"""

from __future__ import annotations

import glob
import os
import threading
import time

import numpy as np
import torch
import pytest
from test_torch_obs_runs import TELEMETRY, _telemetry_files

from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.plane.publish import PolicyPoller, PolicyPublisher, policy_path

SAC_DECOUPLED = ["exp=sac_decoupled", "fabric.devices=auto", "env.id=Pendulum-v1", "env.num_envs=2",
                 "env.capture_video=False", "env.vectorization=async", "buffer.memmap=False", "buffer.size=1024",
                 "per_rank_batch_size=8", "algo.hidden_size=8", "algo.run_test=False", "checkpoint.every=1000000",
                 "checkpoint.save_last=True"]


def test_a_two_player_process_run_merges_its_players(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    result = cli.run(SAC_DECOUPLED + TELEMETRY + [
        "plane.num_players=2", "total_steps=96", "algo.learning_starts=32", "plane.keep_policies=3",
        f"root_dir={tmp_path}/logs", "run_name=two", "fabric.accelerator=cpu"])
    log_dir = result["log_dir"]
    summary = _telemetry_files(log_dir)["summary"]
    plane = result["plane"]
    assert summary["plane_traj_slabs"] == plane["slabs"] == 2 * result["updates"]
    assert summary["plane_policy_version"] == plane["policy_version"]
    assert summary["plane_player_restarts"] == 0
    assert {"player0", "player1"} <= set(summary["sources"])
    pools = [name for name in summary["sources"] if "/envpool_" in name]
    assert len(pools) == 2
    # the players' async env steps, folded into the learner's counters as deltas
    players_steps = sum(summary["sources"][f"player{i}"]["env_steps_async"] for i in range(2))
    assert summary["env_steps_async"] == players_steps == result["policy_steps"]
    staleness = summary["staleness"]
    assert staleness["sample_age_s"]["count"] > 0 and staleness["policy_lag_versions"]["count"] == plane["slabs"]
    assert staleness["queue_depth"]["plane_slab_queue"]["samples"] == plane["slabs"]
    assert set(plane["watchdog_beats"]) == {0, 1} and min(plane["watchdog_beats"].values()) > 0
    assert "Time/policy_publish_time" in summary["phase_percentiles"]
    tel_dir = os.path.join(log_dir, "telemetry")
    assert sorted(os.path.basename(p) for p in glob.glob(os.path.join(tel_dir, "trace_rank0_player*.jsonl"))) == [
        "trace_rank0_player0.jsonl", "trace_rank0_player1.jsonl"]
    versions = sorted(os.listdir(os.path.join(log_dir, "policy")))
    assert len(versions) == 3 and versions[-1] == f"policy_{plane['policy_version']:08d}"


def test_a_gateway_follows_a_live_process_plane_run(tmp_path, monkeypatch):
    from sheeprl_tpu_torch.serve import ServeGateway
    from sheeprl_tpu_torch.serve.model import GatewayModel, load_gateway_model

    monkeypatch.chdir(tmp_path)
    first = cli.run(SAC_DECOUPLED + ["dry_run=True", f"root_dir={tmp_path}/first", "run_name=first",
                                     "fabric.accelerator=cpu", "metric.log_level=0"])
    model, cfg, observation_space, action_space = load_gateway_model(first["checkpoint"], device="cpu")
    base = GatewayModel(model.policy, version=-1, algo=model.algo, env_id=model.env_id, device="cpu")
    gateway = ServeGateway(base, cfg=cfg, observation_space=observation_space, action_space=action_space)
    outcome = {}

    def live_run():
        try:
            outcome["result"] = cli.run(SAC_DECOUPLED + [
                "plane.num_players=1", "total_steps=1500", "algo.learning_starts=16", "metric.log_level=0",
                f"root_dir={tmp_path}/live", "run_name=live", "fabric.accelerator=cpu"])
        except BaseException as exc:  # surfaced by the assertions below
            outcome["error"] = exc

    runner = threading.Thread(target=live_run, name="live-decoupled-run")
    runner.start()
    try:
        policy_root = os.path.join(str(tmp_path), "live", "live", "version_0", "policy")
        deadline = time.monotonic() + 120
        while not os.path.isdir(policy_root) and time.monotonic() < deadline and runner.is_alive():
            time.sleep(0.05)
        swapper = gateway.watch(policy_root, poll_interval_s=0.05)
        while swapper.swaps == 0 and time.monotonic() < deadline and runner.is_alive():
            time.sleep(0.05)
        live_at_swap = runner.is_alive()
        swapped_to = gateway.batcher.model.version
        obs = {k: np.zeros((2, *s.shape), np.float32) for k, s in observation_space.items()}
        actions = gateway.batcher.model.act(obs, None, torch.Generator())[0]
    finally:
        runner.join(timeout=300)
        gateway.close()
    assert "error" not in outcome, outcome.get("error")
    assert swapper.swaps >= 1 and live_at_swap and not swapper.refused
    assert 0 <= swapped_to <= outcome["result"]["plane"]["policy_version"]
    assert np.isfinite(np.asarray(actions)).all()


def test_close_stops_a_writer_process_that_never_gets_its_turn(tmp_path):
    import multiprocessing as mp

    ctx = mp.get_context("forkserver")
    publisher = PolicyPublisher(str(tmp_path / "policy"), algo="sac_decoupled", async_publish=True, mp_context=ctx)
    publisher._start_writer()
    publisher._turn.value = 1_000  # no sequence number reaches this turn: the writer waits for it
    publisher.publish(1, {"w": np.zeros(3, np.float32)})
    writers = list(publisher._procs)
    t0 = time.monotonic()
    publisher.close(timeout=1.0)
    assert time.monotonic() - t0 < 30
    assert not any(p.is_alive() for p in writers)


def test_a_writer_process_lands_every_version_in_order_and_raises_a_failure(tmp_path):
    import multiprocessing as mp

    ctx = mp.get_context("forkserver")
    root = str(tmp_path / "policy")
    publisher = PolicyPublisher(root, keep_policies=2, algo="sac_decoupled", async_publish=True, mp_context=ctx)
    for version in range(1, 6):
        publisher.publish(version, {"w": np.full(3, version, np.float32)})
    with pytest.raises(ValueError, match="monotone"):
        publisher.publish(5, {"w": np.zeros(3, np.float32)})
    publisher.close()
    assert sorted(os.listdir(root)) == ["policy_00000004", "policy_00000005"]
    assert PolicyPoller(root).wait_min_version(4)[1]["w"].tolist() == [4.0, 4.0, 4.0]

    failing = str(tmp_path / "failing")
    publisher = PolicyPublisher(failing, algo="sac_decoupled", async_publish=True, mp_context=ctx)
    with open(policy_path(failing, 1) + ".tmp", "w"):
        pass  # a file where the writer makes its directory
    publisher.publish(1, {"w": np.zeros(3, np.float32)})
    deadline, version = time.monotonic() + 30, 1
    with pytest.raises(RuntimeError, match="writer process"):
        while time.monotonic() < deadline:
            version += 1
            publisher.publish(version, {"w": np.zeros(3, np.float32)})
            time.sleep(0.05)
    publisher.close()


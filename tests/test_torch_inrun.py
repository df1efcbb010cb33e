"""In-run evaluation and the policy-publication channel on the CPU.

- A short DreamerV3 run of the port with ``eval.every_n_steps`` publishes
  its acting modules; the spawned eval process scores them and writes
  ``telemetry/sidecar_evalproc.json`` (the curve, and that it never
  initialised CUDA). The run's losses (its event file) and final weights
  equal, bit for bit, those of the same run with in-run evaluation off.
- The channel: versions strictly monotone, old ones collected, ``.tmp``
  partials skipped, and each package's poller reads the other's
  publications. Sidecars land where the JAX package puts them.
"""

import json
import os

import numpy as np
import pytest

from sheeprl_tpu.ckpt import read_checkpoint as jax_read_checkpoint
from sheeprl_tpu.evals.inrun import InRunEval as JaxInRunEval
from sheeprl_tpu.obs.dist.aggregate import sidecar_path as jax_sidecar_path
from sheeprl_tpu.plane.publish import PolicyPoller as JaxPolicyPoller
from sheeprl_tpu.plane.publish import PolicyPublisher as JaxPolicyPublisher
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.ckpt import read_checkpoint
from sheeprl_tpu_torch.evals.inrun import InRunEval, maybe_start_inrun_eval
from sheeprl_tpu_torch.obs.dist.aggregate import sidecar_path, write_sidecar
from sheeprl_tpu_torch.plane.publish import PlaneClosed, PolicyPoller, PolicyPublisher, policy_path
from sheeprl_tpu_torch.utils.tb_events import read_events
from test_torch_evals import cartpole_args

EVERY = 8


def _run(root, name, extra):
    args = cartpole_args(root / "logs", name, "dreamer_v3", [
        "fabric.accelerator=cpu", "total_steps=32", "algo.learning_starts=8", "metric.log_level=1",
        "metric.log_every=8", "eval.inrun_episodes=2", *extra,
    ])
    return cli.run(args)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("inrun")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        return _run(root, "off", []), _run(root, "on", [f"eval.every_n_steps={EVERY}"])
    finally:
        os.chdir(cwd)


def test_the_run_publishes_and_the_eval_process_writes_the_curve(runs):
    off, on = runs
    assert off["inrun_publishes"] == 0 and on["gradient_steps"] == off["gradient_steps"] > 0
    # published at the first step past learning_starts, then every EVERY policy steps
    assert on["inrun_publishes"] == 4
    with open(sidecar_path(os.path.join(on["log_dir"], "telemetry"), "evalproc")) as f:
        curve = json.load(f)
    assert curve["protocol"] == "frozen-greedy" and curve["episodes"] == 2 and curve["rounds"] >= 1
    versions = [p["policy_version"] for p in curve["points"]]
    assert versions == sorted(versions) and versions[-1] == curve["last_policy_version"] == 32
    assert all(np.isfinite(p["mean"]) and p["mean"] > 0 for p in curve["points"])
    assert curve["cuda_initialized"] is False
    # the publications kept: the newest two, policy-only manifests
    kept = sorted(os.listdir(os.path.join(on["log_dir"], "inrun_policies")))
    assert kept == ["policy_00000024", "policy_00000032"]


def test_in_run_evaluation_leaves_the_run_bit_for_bit_unchanged(runs):
    off, on = runs

    def losses(path):
        return [(e["step"], v["tag"], v["simple_value"]) for e in read_events(path) for v in e.get("values", [])
                if v.get("tag", "").startswith("Loss/")]

    theirs = losses(off["event_file"])
    assert len({tag for _s, tag, _v in theirs}) >= 3
    assert losses(on["event_file"]) == theirs
    a, b = read_checkpoint(off["checkpoint"])["agent"], read_checkpoint(on["checkpoint"])["agent"]
    for module in ("world_model", "actor", "critic"):
        for k in a[module]:
            np.testing.assert_array_equal(a[module][k], b[module][k], err_msg=f"{module}.{k}")


def test_no_eval_process_without_every_n_steps(tmp_path):
    from sheeprl_tpu_torch.utils import dotdict

    cfg = dotdict({"eval": {"every_n_steps": 0}, "algo": {"name": "dreamer_v3"}})
    assert maybe_start_inrun_eval(None, cfg, str(tmp_path)) is None
    cfg.eval.every_n_steps = 4
    assert maybe_start_inrun_eval(None, cfg, None) is None


@pytest.mark.parametrize("steps", [[0, 3, 4, 8, 9, 12, 20], [5, 5, 6, 30, 31, 33]])
def test_the_publication_gate_is_the_jax_gate(steps):
    class Gate:
        every_n_steps = 4
        _last_version = None

    ours, theirs = Gate(), Gate()
    for step in steps:
        due = InRunEval.due(ours, step)
        assert due == JaxInRunEval.due(theirs, step)
        if due:
            ours._last_version = theirs._last_version = step


def test_the_channel_is_monotone_collects_old_versions_and_skips_partials(tmp_path):
    root = str(tmp_path / "pol")
    publisher = PolicyPublisher(root, keep_policies=2, algo="dreamer_v3", async_publish=True)
    for v in (1, 2, 3):
        publisher.publish(v, {"w": np.full(3, v, np.float32)})
    with pytest.raises(ValueError, match="monotone"):
        publisher.publish(3, {"w": np.zeros(3, np.float32)})
    publisher.close()
    os.makedirs(policy_path(root, 9) + ".tmp")
    assert sorted(os.listdir(root)) == ["policy_00000002", "policy_00000003", "policy_00000009.tmp"]
    poller = PolicyPoller(root)
    assert poller.latest_version() == 3
    version, params = poller.wait_min_version(2)
    assert version == 2 and params["w"].tolist() == [2, 2, 2]
    assert poller.wait_min_version(0, use_exact=False)[0] == 3

    class Stopped:
        def is_set(self):
            return True

    with pytest.raises(PlaneClosed):
        poller.wait_min_version(4, stop=Stopped())


def test_each_package_reads_the_other_packages_publications(tmp_path):
    state = {"agent": {"actor": {"w": np.arange(4, dtype=np.float32)}}}
    PolicyPublisher(str(tmp_path / "port"), algo="dreamer_v3").publish(7, state)
    JaxPolicyPublisher(str(tmp_path / "jax"), algo="dreamer_v3").publish(7, state)
    for reader in (PolicyPoller(str(tmp_path / "jax")), JaxPolicyPoller(str(tmp_path / "port"))):
        np.testing.assert_array_equal(reader.load(7)["agent"]["actor"]["w"], state["agent"]["actor"]["w"])
    manifest = jax_read_checkpoint(policy_path(str(tmp_path / "port"), 7))
    assert int(manifest["version"]) == 7


def test_sidecars_land_where_the_jax_package_puts_them(tmp_path):
    tel = str(tmp_path / "telemetry")
    assert sidecar_path(tel, "evalproc") == jax_sidecar_path(tel, "evalproc")
    path = write_sidecar(tel, "evalproc", {"points": [1, 2]})
    with open(path) as f:
        assert json.load(f) == {"points": [1, 2]}
    assert os.listdir(tel) == ["sidecar_evalproc.json"]
    assert write_sidecar(os.path.join(path, "not_a_dir"), "x", {}) is None

"""The data-parallel CLI checks shared by ``tests/test_torch_ddp_cli_*.py``:
one command run by both packages at ``fabric.devices=2`` on the CPU (the
JAX package on two of the conftest's virtual devices in this process, the
port on two gloo ranks: this process and one it spawns), then the port's
run resumed from its checkpoint at two ranks.

What one run is held to:

- the step counters of ``telemetry.json`` (``policy_steps``,
  ``train_steps``) and the loop's ``policy_steps`` equal the JAX run's;
- the checkpoints: every JAX ``ckpt_<step>_0`` has the port's
  ``ckpt_<step>_0`` (the model and rank 0's buffer) and ``ckpt_<step>_1``
  (rank 1's buffer, no model), and the last one's ``update`` and
  ``batch_size`` are the JAX checkpoint's;
- rank 0's ``telemetry.json`` merges rank 1's sidecar (``sources`` has
  ``rank1``; the collectives' counters are both ranks' sum);
- the logged episode metrics (``Rewards/rew_avg``, ``Game/ep_len_avg``,
  over every rank's envs) equal the JAX run's at every logged step;
- the resumed run goes on to its new end (repeating its checkpoint's
  update, as the JAX loop does) and checkpoints both ranks again.
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict, List

from sheeprl_tpu.ckpt.resume import read_checkpoint as jax_read_checkpoint
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.ckpt import read_manifest
from sheeprl_tpu_torch.ckpt.resume import read_checkpoint
from sheeprl_tpu_torch.utils.tb_events import read_events

COMMON = ["fabric.accelerator=cpu", "fabric.devices=2", "env.num_envs=2", "metric=telemetry", "metric.log_every=16",
          "buffer.memmap=False", "buffer.checkpoint=True", "checkpoint.every=32", "algo.run_test=False"]
EPISODE_TAGS = ("Rewards/rew_avg", "Game/ep_len_avg")
REPO = Path(__file__).resolve().parents[1]


JAX_RUN = "import sys; sys.path.insert(0, {repo!r}); from sheeprl_tpu import cli; cli.run(sys.argv[1:])"


def run_both(root: str, args: List[str]) -> Dict[str, Any]:
    """The JAX run (in a process of its own, beside the port's: the JAX
    loops leave their ``SummaryWriter`` open, and tensorboardX writes its
    queue out at the process's exit) and the port's run of ``args`` under
    ``root``."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=8",
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-c", JAX_RUN.format(repo=str(REPO)), *args, *COMMON,
                             f"root_dir={root}/jax", "run_name=r"], cwd=root, env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        port = cli.run(args + COMMON + [f"root_dir={root}/port", "run_name=r"])
    finally:
        os.chdir(cwd)
        _out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    return {"root": root, "args": args, "jax_dir": sorted(glob.glob(f"{root}/jax/r/version_*"))[-1], "port": port}


def _episode_metrics(log_dir: str) -> Dict[int, Dict[str, float]]:
    (path,) = glob.glob(os.path.join(log_dir, "events.out.tfevents.*"))
    out: Dict[int, Dict[str, float]] = {}
    for e in read_events(path)[1:]:
        for v in e.get("values", []):
            if v["tag"] in EPISODE_TAGS:
                out.setdefault(e["step"], {})[v["tag"]] = v["simple_value"]
    return out


def _ckpts(log_dir: str) -> List[str]:
    return sorted(os.path.basename(p) for p in glob.glob(os.path.join(log_dir, "checkpoint", "ckpt_*")))


def check_run(runs: Dict[str, Any]) -> None:
    jax_dir, port = runs["jax_dir"], runs["port"]
    port_dir = port["log_dir"]
    with open(os.path.join(jax_dir, "telemetry.json")) as f:
        jt = json.load(f)
    with open(os.path.join(port_dir, "telemetry.json")) as f:
        pt = json.load(f)
    assert (pt["policy_steps"], pt["train_steps"]) == (jt["policy_steps"], jt["train_steps"])
    assert port["policy_steps"] == jt["policy_steps"]

    jax_ckpts = _ckpts(jax_dir)
    assert jax_ckpts and all(c.endswith("_0") for c in jax_ckpts)
    assert _ckpts(port_dir) == sorted(jax_ckpts + [c[:-2] + "_1" for c in jax_ckpts])
    last = max(jax_ckpts, key=lambda c: int(c.split("_")[1]))
    want = jax_read_checkpoint(os.path.join(jax_dir, "checkpoint", last))
    got = read_checkpoint(os.path.join(port_dir, "checkpoint", last), with_rb=False)
    assert int(got["update"]) == int(want["update"]) and int(got["batch_size"]) == int(want["batch_size"])
    rank0 = read_manifest(os.path.join(port_dir, "checkpoint", last))
    rank1 = read_manifest(os.path.join(port_dir, "checkpoint", last[:-2] + "_1"))
    assert rank0["state"] is not None and rank0["rb"] is not None and rank0["world_size"] == 2
    assert rank1["state"] is None and rank1["rb"] is not None and rank1["rank"] == 1

    assert "rank1" in pt["sources"]
    rank1_ops = pt["sources"]["rank1"]["comms_ops"]
    assert rank1_ops > 0 and pt["comms_ops"] > rank1_ops

    episodes = _episode_metrics(port_dir)
    assert episodes and episodes == _episode_metrics(jax_dir)


def check_resume(runs: Dict[str, Any], total_steps: int) -> None:
    """Resume the port's run at two ranks from its last checkpoint and run
    it to ``total_steps``."""
    port = runs["port"]
    last = sorted(glob.glob(os.path.join(port["log_dir"], "checkpoint", "ckpt_*_0")),
                  key=lambda p: int(os.path.basename(p).split("_")[1]))[-1]
    root = runs["root"]
    cwd = os.getcwd()
    os.chdir(root)
    try:
        resumed = cli.run(runs["args"] + COMMON + [f"root_dir={root}/resumed", "run_name=r",
                                                   f"checkpoint.resume_from={last}", f"total_steps={total_steps}"])
    finally:
        os.chdir(cwd)
    # the resumed run repeats its checkpoint's update, as the JAX loop does
    assert resumed["policy_steps"] > int(os.path.basename(last).split("_")[1])
    names = _ckpts(resumed["log_dir"])
    step = resumed["policy_steps"]
    assert f"ckpt_{step}_0" in names and f"ckpt_{step}_1" in names

#!/usr/bin/env python
"""The learning tests' configs at several seeds, on this host's CPU.

``tests/test_algos/test_learning.py`` runs PPO, A2C and PPO-recurrent on
gymnasium's ``CartPole-v1`` at one seed each and holds the episodes'
returns to a criterion: more than 50 episodes, the last 10's mean above a
limit and above a factor times the first 10's. ``sac_decoupled_td`` is its
``test_sac_learns_pendulum`` config (more than 30 episodes, the last 10's
mean above -700 and 300 above the first 10's) on the decoupled SAC learner
with 2 player processes, 2 replay shards and TD priorities: the JAX
entrypoint at ``fabric.devices=2`` (its mesh splits the 4 envs and the
128-row batch over the two devices), the port's at ``fabric.devices=auto``
with the same 4 envs and 128 rows. This script runs one of
those configs, unchanged but for the seed, through the CLI of either
package (the JAX one, ``sheeprl_tpu``, or the PyTorch port,
``sheeprl_tpu_torch``, with ``fabric.accelerator=cpu``), and prints one JSON
line a seed: the episodes, the first and last 10's means and whether the
criterion holds. It is the CPU side of the seed table in PERF.md; the
card's side is ``python3 chip_smoke.py --seeds <run> <seed> ...``.

Usage::

    JAX_PLATFORMS=cpu python tools/learning_seeds.py --package sheeprl_tpu_torch --algo a2c --seeds 0 1 2 3 4
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import io
import json
import os
import sys
import tempfile
import time

import numpy as np

# test_learning.py's overrides for each algorithm (:20-60, :108-149, :151-194), its seed left out
CONFIGS = {
    "ppo": ["exp=ppo", "env=gym", "env.id=CartPole-v1", "total_steps=40960", "algo.rollout_steps=64",
            "per_rank_batch_size=64", "env.num_envs=8", "algo.anneal_lr=True"],
    "a2c": ["exp=a2c", "total_steps=40000", "env.num_envs=8"],
    "ppo_recurrent": ["exp=ppo_recurrent", "env=gym", "env.id=CartPole-v1", "total_steps=49152", "env.num_envs=8",
                      "algo.rollout_steps=128", "per_rank_sequence_length=8", "per_rank_batch_size=32"],
}
COMMON = ["env.sync_env=True", "env.capture_video=False", "fabric.devices=1", "fabric.accelerator=cpu",
          "metric.log_level=1", "metric.log_every=100000", "buffer.memmap=False", "checkpoint.save_last=False",
          "checkpoint.every=100000000", "algo.run_test=False"]
#: the decoupled config's overrides, then each package's (the JAX learner's mesh of 2 devices halves the per-device
#: envs and batch); its players step the shared-memory worker pool
DECOUPLED = ["exp=sac_decoupled", "env=gym", "env.id=Pendulum-v1", "total_steps=32768", "algo.learning_starts=1000",
             "plane.num_players=2", "replay.shards=2", "replay.strategy=td_priority", "env.vectorization=async",
             "env.capture_video=False", "fabric.accelerator=cpu", "metric.log_level=1", "metric.log_every=100000",
             "buffer.memmap=False", "checkpoint.save_last=False", "checkpoint.every=100000000", "algo.run_test=False"]
CONFIGS["sac_decoupled_td"] = DECOUPLED
PACKAGE_OVERRIDES = {
    "sac_decoupled_td": {
        "sheeprl_tpu": ["fabric.devices=2", "env.num_envs=2", "per_rank_batch_size=64"],
        "sheeprl_tpu_torch": ["fabric.devices=auto", "env.num_envs=4", "per_rank_batch_size=128"],
    },
}


def on_policy(limit: float, factor: float):
    """More than 50 episodes, the last 10's mean above ``limit`` and above ``factor`` times the first 10's."""
    return lambda n, early, late: n > 50 and late > limit and late > factor * early


#: each config's criterion on (episodes, first 10's mean, last 10's mean)
CRITERIA = {"ppo": on_policy(150.0, 3.0), "a2c": on_policy(80.0, 2.0), "ppo_recurrent": on_policy(60.0, 3.0),
            "sac_decoupled_td": lambda n, early, late: n > 30 and late > -700 and late > early + 300}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--package", choices=("sheeprl_tpu", "sheeprl_tpu_torch"), required=True)
    parser.add_argument("--algo", choices=sorted(CONFIGS), required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if args.package == "sheeprl_tpu" and args.algo in PACKAGE_OVERRIDES:
        # the JAX learner's two devices: virtual CPU devices, set before jax is imported
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=2").strip()
    cli = importlib.import_module(f"{args.package}.cli")
    criterion = CRITERIA[args.algo]
    overrides = CONFIGS[args.algo] + (PACKAGE_OVERRIDES[args.algo][args.package] if args.algo in PACKAGE_OVERRIDES
                                      else COMMON)
    for seed in args.seeds:
        printed = io.StringIO()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as root, contextlib.redirect_stdout(printed):
            cli.run(overrides + [f"seed={seed}", f"root_dir={root}", "run_name=seed"])
        # the coupled loops print "reward_env_<i>=<return>", the decoupled learners "reward=<return>"
        rewards = [float(line.rsplit("=", 1)[-1]) for line in printed.getvalue().splitlines()
                   if "policy_step=" in line and "reward" in line]
        early, late = float(np.mean(rewards[:10])), float(np.mean(rewards[-10:]))
        print(json.dumps({"package": args.package, "algo": args.algo, "seed": seed, "episodes": len(rewards),
                          "early": early, "late": late,
                          "passed": criterion(len(rewards), early, late),
                          "seconds": round(time.perf_counter() - t0, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""The on-policy learning tests' configs at several seeds, on this host's CPU.

``tests/test_algos/test_learning.py`` runs PPO, A2C and PPO-recurrent on
gymnasium's ``CartPole-v1`` at one seed each and holds the episodes'
returns to a criterion: more than 50 episodes, the last 10's mean above a
limit and above a factor times the first 10's. This script runs one of
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
#: (limit on the last 10 episodes' mean, factor over the first 10's)
CRITERIA = {"ppo": (150.0, 3.0), "a2c": (80.0, 2.0), "ppo_recurrent": (60.0, 3.0)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--package", choices=("sheeprl_tpu", "sheeprl_tpu_torch"), required=True)
    parser.add_argument("--algo", choices=sorted(CONFIGS), required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    cli = importlib.import_module(f"{args.package}.cli")
    limit, factor = CRITERIA[args.algo]
    for seed in args.seeds:
        printed = io.StringIO()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as root, contextlib.redirect_stdout(printed):
            cli.run(CONFIGS[args.algo] + COMMON + [f"seed={seed}", f"root_dir={root}", "run_name=seed"])
        rewards = [float(line.rsplit("=", 1)[-1]) for line in printed.getvalue().splitlines() if "reward_env" in line]
        early, late = float(np.mean(rewards[:10])), float(np.mean(rewards[-10:]))
        print(json.dumps({"package": args.package, "algo": args.algo, "seed": seed, "episodes": len(rewards),
                          "early": early, "late": late,
                          "passed": len(rewards) > 50 and late > limit and late > factor * early,
                          "seconds": round(time.perf_counter() - t0, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

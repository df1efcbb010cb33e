"""Where a served DreamerV2 batch spends its time on the card.

    python -m sheeprl_tpu_torch.tools.profile_serve [--batch 64] [--batches 16]

Builds the full-width MsPacman DV2 policy (seeded random weights) on
``cuda``, warms it up, then runs ``--batches`` calls of ``GatewayModel.act``
on seeded uint8 frames of ``--batch`` rows, the device work of one served
batch, under ``torch.profiler``. Prints one JSON line: wall time per batch
(host clock, each batch ends in a copy of its actions to the host), device
busy time per batch (the sum of the device's kernel and copy times),
the device's idle share, and the kernels with the most device time. Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sheeprl_tpu_torch.obs.prof.trace import device_us_by_name
    from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_agent
    from sheeprl_tpu_torch.configs import dreamer_v2_config
    from sheeprl_tpu_torch.serve import GatewayModel

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--batches", type=int, default=16)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    obs_space = {"rgb": (3, 64, 64)}
    cfg = dreamer_v2_config()
    wm, actor = build_agent(cfg, (9,), False, obs_space, device="cuda")
    params = {"world_model": wm.state_dict(), "actor": actor.state_dict()}
    model = GatewayModel.from_params(params, cfg, obs_space, (9,), False, device="cuda")
    rng = np.random.RandomState(0)
    frames = rng.randint(0, 256, (args.batches, args.batch, 3, 64, 64)).astype(np.uint8)
    gen = torch.Generator(device=model.device).manual_seed(0)

    def run_batches():
        state = model.init_state_rows(args.batch)
        for f in frames:
            _actions, state = model.act({"rgb": f}, state, gen)

    for _ in range(3):
        run_batches()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_batches()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    # only what ran on the device (the trace parser's raw device events): an
    # operator's own entry repeats the time of the kernels it launched
    by_name = device_us_by_name(prof)
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    n = args.batches
    result = {
        "card": card,
        "batch": args.batch,
        "batches": n,
        "wall_ms_per_batch": 1e3 * wall_s / n,
        "device_busy_ms_per_batch": busy_us / 1e3 / n if busy_us else None,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall_s if busy_us else None,
        "top_device_ms_per_batch": {name[:80]: us / 1e3 / n for name, us in top},
    }
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

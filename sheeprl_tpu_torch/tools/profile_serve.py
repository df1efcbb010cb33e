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


def device_us(evt) -> float:
    """Self device time of a profiler event, in µs (the attribute was renamed
    across PyTorch versions); 0 for a user-annotated range (such as
    ``Optimizer.step#Adam.step``), which spans kernels counted on their own."""
    if getattr(evt, "is_user_annotation", False):
        return 0.0
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(evt, attr, None)
        if value is not None:
            return float(value)
    return 0.0


def main() -> int:
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    # only what ran on the device: an operator's own entry repeats the time
    # of the kernels it launched
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and device_us(e) > 0]
    busy_us = sum(device_us(e) for e in events)
    top = sorted(events, key=device_us, reverse=True)[:10]
    n = args.batches
    result = {
        "card": card,
        "batch": args.batch,
        "batches": n,
        "wall_ms_per_batch": 1e3 * wall_s / n,
        "device_busy_ms_per_batch": busy_us / 1e3 / n if busy_us else None,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall_s if busy_us else None,
        "top_device_ms_per_batch": {e.key[:80]: device_us(e) / 1e3 / n for e in top},
    }
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The DreamerV2 trainer at the MsPacman width: a few gradient steps on a
seeded synthetic batch (counterpart of ``bench_dreamer.py bench.family=dv2``).

    python -m sheeprl_tpu_torch.tools.bench_dreamer [--steps 5] [--profile] [--device cuda]

Builds the world model, actor, critic and target critic at
``exp=dreamer_v2_ms_pacman``'s widths with seeded random weights (``run``
takes ``dreamer_v2_config`` overrides, which the tests use to shrink it),
and the seeded uint8 batch of the JAX bench
(B=32 × T=50 frames of 3×64×64, 9 one-hot actions, Gaussian rewards, no
episode ends). Takes one warm-up step at τ=1, then ``--steps`` timed steps
at τ=0, and prints one JSON line: steps/s (host clock around the timed
steps, the device synchronised at both ends), the last step's losses, the
recurrent cell's launches per step and the sequence kernel's launches, and
the trainer's peak device memory over the timed steps (weights, optimizer
state, batch and activations; not what the caller held before ``run``).
``--profile`` adds a ``torch.profiler`` window of
the same number of steps: the device's busy time per step, its idle share
in that window and over the timed steps' wall time (the profiler slows the
host, not the device), its top operations and the cell kernels' share of
device time. Runs on ``cuda`` unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, Optional

ACTIONS = (9,)
OBS = {"rgb": (3, 64, 64)}


def synthetic_batch(T: int, B: int, actions_dim: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """A seeded synthetic replay batch on the host, as the JAX
    ``bench_dreamer.py`` makes it: uint8 frames ``[T, B, 3, 64, 64]``,
    one-hot actions, Gaussian rewards, no episode ends."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return {
        "rgb": rng.integers(0, 256, size=(T, B, 3, 64, 64)).astype(np.uint8),
        "actions": np.eye(actions_dim, dtype=np.float32)[rng.integers(0, actions_dim, (T, B))],
        "rewards": rng.normal(size=(T, B, 1)).astype(np.float32),
        "dones": np.zeros((T, B, 1), np.float32),
        "is_first": np.zeros((T, B, 1), np.float32),
    }


def build_trainer(device=None, seed: int = 0, **overrides):
    """``(cfg, state, train_step, data)`` at the MsPacman width (with
    ``overrides``) on ``device``; the state's generator draws the noise."""
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import build_optimizers_and_state, build_train_fn
    from sheeprl_tpu_torch.configs import dreamer_v2_config
    from sheeprl_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    cfg = dreamer_v2_config(**overrides)
    modules = build_agent(cfg, ACTIONS, False, OBS, seed=seed, device=dev, training=True)
    state = build_optimizers_and_state(cfg, *modules, generator=torch.Generator(device=dev).manual_seed(seed))
    T, B = int(cfg.per_rank_sequence_length), int(cfg.per_rank_batch_size)
    data = {k: torch.from_numpy(v).to(dev) for k, v in synthetic_batch(T, B, ACTIONS[0], seed=seed).items()}
    return cfg, state, build_train_fn(cfg, ACTIONS, False), data


def profile_steps(train_step, state, data, steps: int) -> Dict[str, Any]:
    """Device busy time, idle share and top operations over ``steps`` steps
    under ``torch.profiler`` (kernel and copy times from CUPTI)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sheeprl_tpu_torch.tools.profile_serve import device_us

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            train_step(state, data, tau=0.0)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and device_us(e) > 0]
    busy_us = sum(device_us(e) for e in events)
    cell_us = sum(device_us(e) for e in events if "hafner" in e.key)
    product_us = sum(device_us(e) for e in events if "hafner_product" in e.key)
    top = sorted(events, key=device_us, reverse=True)[:12]
    return {
        "profiled_steps": steps,
        "wall_ms_per_step_profiled": 1e3 * wall_s / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall_s,
        "cell_kernels_ms_per_step": cell_us / 1e3 / steps,
        "cell_product_ms_per_step": product_us / 1e3 / steps,
        "cell_gates_ms_per_step": (cell_us - product_us) / 1e3 / steps,
        "cell_share_of_device_time": cell_us / busy_us if busy_us else None,
        "top_device_ms_per_step": {e.key[:90]: device_us(e) / 1e3 / steps for e in top},
    }


def run(steps: int = 5, device=None, profile: bool = False, seed: int = 0, **overrides) -> Dict[str, Any]:
    """Warm-up at τ=1, ``steps`` timed steps at τ=0; returns the JSON line's dict."""
    import torch

    from sheeprl_tpu_torch.device import resolve_device
    from sheeprl_tpu_torch.kernels import ops

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    # what the caller already holds on the card is not the trainer's
    base_bytes = torch.cuda.memory_allocated(dev) if cuda else 0
    cfg, state, train_step, data = build_trainer(dev, seed, **overrides)
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    metrics = train_step(state, data, tau=1.0)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    ops.hafner_cell_launches.reset()
    ops.hafner_sequence_launches.reset()
    t0 = time.perf_counter()
    for _ in range(steps):
        metrics = train_step(state, data, tau=0.0)
    sync()
    wall_s = time.perf_counter() - t0
    cell_launches, seq_launches = ops.hafner_cell_launches.count, ops.hafner_sequence_launches.count
    losses = {k: float(v) for k, v in metrics.items()}
    result: Dict[str, Any] = {
        "metric": "dv2_train_steps_per_s",
        "value": steps / wall_s,
        "unit": "steps/s",
        "steps": steps,
        "batch": [int(cfg.per_rank_sequence_length), int(cfg.per_rank_batch_size)],
        "horizon": int(cfg.algo.horizon),
        "losses": losses,
        "hafner_cell_launches": cell_launches,
        "hafner_cell_launches_per_step": cell_launches / steps,
        "hafner_sequence_launches": seq_launches,
        "peak_device_memory_bytes": torch.cuda.max_memory_allocated(dev) - base_bytes if cuda else None,
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
    }
    if profile:
        if not cuda:
            raise RuntimeError("--profile measures the device: it needs a CUDA card")
        prof = profile_steps(train_step, state, data, steps)
        # the profiler slows the host; the device's work is the same, so its
        # busy time over the unprofiled steps' wall time is the idle share those had
        prof["device_idle_share_of_timed_steps"] = 1.0 - prof["device_busy_ms_per_step"] / (1e3 * wall_s / steps)
        result.update(prof)
    return result


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.steps, args.device, args.profile, args.seed)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The Dreamer trainer at a preset's width: a few gradient steps on a seeded
synthetic batch (counterpart of ``bench_dreamer.py bench.family=dv2`` and
``bench.family=dv3``).

    python -m sheeprl_tpu_torch.tools.bench_dreamer [--algo dreamer_v3_walker] [--steps 5] [--profile] [--device cuda]

Builds the world model, actor, critic and target critic at the widths of a
preset (``--algo``, PRESETS): ``exp=dreamer_v2_ms_pacman`` (``dreamer_v2``,
the default), ``exp=dreamer_v3_100k_ms_pacman`` (``dreamer_v3``),
``exp=dreamer_v3_dmc_walker_walk`` (``dreamer_v3_walker``: rgb and a
24-wide ``state``, 6 continuous actions), ``exp=dreamer_v2`` on a 2-wide
Box of actions (``dreamer_v2_continuous``), or Plan2Explore's exploration
step (``p2e_dv3``, ``exp=p2e_dv3_exploration``, also on the walker's
observations and actions as ``p2e_dv3_continuous``; ``p2e_dv2``,
``exp=p2e_dv2_exploration``), the L and XL widths (``dreamer_v3_L``,
``exp=dreamer_v3_L_doapp``; ``dreamer_v3_XL``, ``exp=dreamer_v3_XL_crafter``),
P2E-DV3's L DIAMBRA exploration preset under its ``bf16-mixed``
(``p2e_dv3_L_bf16``), or DreamerV1 (``dreamer_v1``, ``exp=dreamer_v1`` on
the discrete dummy env's 2 actions; ``dreamer_v1_continuous`` on the
continuous dummy env's 2-wide Box) and its Plan2Explore exploration step
(``p2e_dv1``, ``exp=p2e_dv1_exploration``), with seeded random weights
(``compare`` takes config overrides, which the tests use to shrink it), and
the seeded batch of the JAX bench at the preset's ``B × T`` (DV2: 32 × 50,
DV3 and P2E-DV3: 16 × 64, P2E-DV2: 16 × 50, P2E-DV3 L: 4 × 64, DV1 and
P2E-DV1: 50 × 50) uint8 frames of 3×64×64 (1×64×64 grey); 9 one-hot
actions (16 DIAMBRA, 17 Crafter, 2 the dummy env), or
uniform continuous ones in [−1, 1]; a Gaussian vector for every other
key; Gaussian rewards, no episode ends). Times
the step eager and graphed in one call, each on a fresh trainer of the same
seed: one warm-up step at τ=1, then ``--steps`` timed steps at τ=0. Prints
one JSON line with, for each side, steps/s (host clock around the timed
steps, the device synchronised at both ends), the last step's losses, the
recurrent cell's launches per step and the sequence kernel's launches, and
the trainer's peak device memory from its first step to its last (weights,
optimizer state, batch and activations, and a graph's private pool,
allocated at its capture; not what the caller held before) beside the
memory the caching allocator holds at the end. ``--profile`` adds a
``torch.profiler`` window of the same number of steps: the device's busy
time per step, its idle share in that window and over the timed steps' wall
time (the profiler slows the host, not the device), its top operations and
the cell kernels' share of device time. Runs on ``cuda`` unless given
``--device cpu``.

The eager side times ``program(state, data)``; the graphed side the
training run's path: one-sample bursts (``program.burst``), each step
replayed from the captured graph after the capture's eager warm-up calls,
which run before the timed steps.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, Optional

ACTIONS = (9,)
OBS = {"rgb": (3, 64, 64)}
WALKER_OBS = {"rgb": (3, 64, 64), "state": (24,)}
#: DIAMBRA's Dead or Alive++ as the preset's keys see it (the DIAMBRA wrapper's spaces: every non-Box key a
#: 1-wide Box) and its 16 combo-discrete actions (9 moves + 8 attack-button combinations - 1 shared no-op);
#: the L preset's legacy key names with an RGB frame, and the P2E L presets' role-relative names with a grey frame
#: and the reward as an observation
DOAPP_L_OBS = {"frame": (3, 64, 64), **{k: (1,) for k in (
    "P1_actions_attack", "P1_actions_move", "P1_oppChar", "P1_oppHealth", "P1_oppSide", "P1_oppWins", "P1_ownChar",
    "P1_ownHealth", "P1_ownSide", "P1_ownWins", "stage")}}
DOAPP_P2E_OBS = {"frame": (1, 64, 64), **{k: (1,) for k in (
    "own_character", "own_health", "own_side", "own_wins", "opp_character", "opp_health", "opp_side", "opp_wins",
    "stage", "timer", "action", "reward")}}
DOAPP_ACTIONS = (16,)
#: Crafter: its frame and the reward as an observation, its 17 actions
CRAFTER_OBS = {"rgb": (3, 64, 64), "reward": (1,)}
CRAFTER_ACTIONS = (17,)
#: the dummy envs' actions: 2 discrete (``discrete_dummy``) or a 2-wide Box (``continuous_dummy``)
DUMMY_ACTIONS = (2,)
#: the agent and training modules of each family
ALGOS = {
    "dreamer_v1": ("sheeprl_tpu_torch.algos.dreamer_v1.agent", "sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1"),
    "p2e_dv1": ("sheeprl_tpu_torch.algos.p2e_dv1.agent", "sheeprl_tpu_torch.algos.p2e_dv1.p2e_dv1_exploration"),
    "dreamer_v2": ("sheeprl_tpu_torch.algos.dreamer_v2.agent", "sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2"),
    "dreamer_v3": ("sheeprl_tpu_torch.algos.dreamer_v3.agent", "sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3"),
    "p2e_dv2": ("sheeprl_tpu_torch.algos.p2e_dv2.agent", "sheeprl_tpu_torch.algos.p2e_dv2.p2e_dv2_exploration"),
    "p2e_dv3": ("sheeprl_tpu_torch.algos.p2e_dv3.agent", "sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_exploration"),
}
#: ``--algo`` → (family, ``exp=``, observation shapes, actions, continuous[, config overrides])
PRESETS = {
    "dreamer_v2": ("dreamer_v2", "dreamer_v2_ms_pacman", OBS, ACTIONS, False),
    "dreamer_v3": ("dreamer_v3", "dreamer_v3_100k_ms_pacman", OBS, ACTIONS, False),
    "dreamer_v3_walker": ("dreamer_v3", "dreamer_v3_dmc_walker_walk", WALKER_OBS, (6,), True),
    "dreamer_v2_continuous": ("dreamer_v2", "dreamer_v2", OBS, (2,), True),
    # Plan2Explore's exploration step at its presets' widths: DV3's default (dense 256, recurrent 256, 32x32
    # latent, B=16 x T=64, an 8-member ensemble, two exploration critics) and DV2's (dense 400 x 4, recurrent
    # 400, B=16 x T=50, 10 members); the DV3 one also on the walker's observations and 6 continuous actions
    "p2e_dv3": ("p2e_dv3", "p2e_dv3_exploration", OBS, ACTIONS, False),
    "p2e_dv3_continuous": ("p2e_dv3", "p2e_dv3_exploration", WALKER_OBS, (6,), True,
                           {"mlp_keys.encoder": ["state"], "mlp_keys.decoder": ["state"]}),
    "p2e_dv2": ("p2e_dv2", "p2e_dv2_exploration", OBS, ACTIONS, False),
    # the L and XL widths in f32 (DIAMBRA's L preset: recurrent 2048, dense 768 x 4, CNN multiplier 64, B=16 x T=64;
    # Crafter's XL: recurrent 4096, dense 1024 x 5, CNN multiplier 96), and P2E-DV3's L DIAMBRA exploration preset
    # under its bf16-mixed (recurrent 1024, dense 768 x 4, CNN multiplier 48, B=4 x T=64)
    "dreamer_v3_L": ("dreamer_v3", "dreamer_v3_L_doapp", DOAPP_L_OBS, DOAPP_ACTIONS, False),
    "dreamer_v3_XL": ("dreamer_v3", "dreamer_v3_XL_crafter", CRAFTER_OBS, CRAFTER_ACTIONS, False),
    "p2e_dv3_L_bf16": ("p2e_dv3", "p2e_dv3_expl_L_doapp_128px_gray_combo_discrete_15Mexpl_20Mstps", DOAPP_P2E_OBS,
                       DOAPP_ACTIONS, False),
    # DreamerV1 at its preset's width (recurrent 200, Gaussian stochastic 30, dense 400 x 4, CNN multiplier 32,
    # B=50 x T=50, horizon 15) on the dummy envs' spaces (2 discrete actions, or a 2-wide Box), and P2E-DV1's
    # exploration step at its own (recurrent 400, stochastic 60, hidden 400, 10 members regressing the 1024-wide
    # embedding)
    "dreamer_v1": ("dreamer_v1", "dreamer_v1", OBS, DUMMY_ACTIONS, False),
    "dreamer_v1_continuous": ("dreamer_v1", "dreamer_v1", OBS, DUMMY_ACTIONS, True),
    "p2e_dv1": ("p2e_dv1", "p2e_dv1_exploration", OBS, DUMMY_ACTIONS, False),
}


def synthetic_batch(T: int, B: int, actions_dim: int, seed: int = 0, continuous: bool = False,
                    obs=None) -> Dict[str, np.ndarray]:
    """A seeded synthetic replay batch on the host, as the JAX
    ``bench_dreamer.py`` makes it: uint8 frames ``[T, B, 3, 64, 64]`` (and a
    Gaussian float vector for each other key of ``obs``), one-hot actions
    (uniform in [−1, 1] when ``continuous``), Gaussian rewards, no episode
    ends."""
    import numpy as np

    obs = OBS if obs is None else obs
    rng = np.random.default_rng(seed)
    batch = {
        k: rng.integers(0, 256, size=(T, B) + tuple(shape)).astype(np.uint8) if len(shape) == 3
        else rng.normal(size=(T, B) + tuple(shape)).astype(np.float32)
        for k, shape in obs.items()
    }
    if continuous:
        batch["actions"] = rng.uniform(-1.0, 1.0, (T, B, actions_dim)).astype(np.float32)
    else:
        batch["actions"] = np.eye(actions_dim, dtype=np.float32)[rng.integers(0, actions_dim, (T, B))]
    batch.update(
        rewards=rng.normal(size=(T, B, 1)).astype(np.float32),
        dones=np.zeros((T, B, 1), np.float32),
        is_first=np.zeros((T, B, 1), np.float32),
    )
    return batch


def build_trainer(device=None, seed: int = 0, algo: str = "dreamer_v2", **overrides):
    """``(cfg, state, program, data)`` of the preset ``algo`` (PRESETS) at
    its width (with ``overrides``) on ``device``: ``program`` is the
    gradient step's ``TrainProgram``; the state's generator draws the
    noise."""
    import importlib

    import torch

    from sheeprl_tpu_torch import configs
    from sheeprl_tpu_torch.device import resolve_device

    family, exp, obs, actions, continuous, *preset_overrides = PRESETS[algo]
    agent_module, train_module = ALGOS[family]
    agent, train = importlib.import_module(agent_module), importlib.import_module(train_module)
    dev = resolve_device(device)
    cfg = configs.dreamer_v2_config(exp, **{**(preset_overrides[0] if preset_overrides else {}), **overrides})
    modules = agent.build_agent(cfg, actions, continuous, obs, seed=seed, device=dev, training=True)
    state = train.build_optimizers_and_state(cfg, *modules, generator=torch.Generator(device=dev).manual_seed(seed))
    T, B = int(cfg.per_rank_sequence_length), int(cfg.per_rank_batch_size)
    batch = synthetic_batch(T, B, int(sum(actions)), seed=seed, continuous=continuous, obs=obs)
    data = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    return cfg, state, train.build_train_fn(cfg, actions, continuous), data


def _metric(algo: str) -> str:
    return f"{algo.replace('dreamer_v', 'dv')}_train_steps_per_s"


def profile_steps(step, steps: int) -> Dict[str, Any]:
    """Device busy time, idle share and top operations over ``steps`` calls
    of ``step()`` under ``torch.profiler`` (kernel and copy times from CUPTI;
    the device's activity alone: host operations are not traced)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    by_name = _device_us_by_name(prof)
    busy_us = sum(by_name.values())
    cell_us = sum(us for name, us in by_name.items() if "hafner" in name)
    product_us = sum(us for name, us in by_name.items() if "hafner_product" in name)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {
        "profiled_steps": steps,
        "wall_ms_per_step_profiled": 1e3 * wall_s / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall_s,
        "cell_kernels_ms_per_step": cell_us / 1e3 / steps,
        "cell_product_ms_per_step": product_us / 1e3 / steps,
        "cell_gates_ms_per_step": (cell_us - product_us) / 1e3 / steps,
        "cell_share_of_device_time": cell_us / busy_us if busy_us else None,
        "top_device_ms_per_step": {name[:90]: us / 1e3 / steps for name, us in top},
    }


def _device_us_by_name(prof) -> Dict[str, float]:
    """Device µs by kernel (or copy) name over a profiler window, summed from
    the profiler's raw device events (a user-annotated range spans kernels
    counted on their own, so it is left out); building its function events
    and ``key_averages()`` gives the same sums but takes seconds a window at
    these steps' tens of thousands of kernels. A PyTorch without the raw
    events reads the averages."""
    from torch.autograd import DeviceType

    from sheeprl_tpu_torch.tools.profile_serve import device_us

    try:
        events = prof.profiler.kineto_results.events()
    except AttributeError:
        events = None
    out: Dict[str, float] = {}
    if events is None:
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and device_us(e) > 0:
                out[e.key] = out.get(e.key, 0.0) + device_us(e)
        return out
    for e in events:
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        us = e.duration_ns() / 1e3 if hasattr(e, "duration_ns") else e.duration_us()
        out[e.name()] = out.get(e.name(), 0.0) + us
    return out


def run(steps: int = 5, device=None, profile: bool = False, seed: int = 0, mode: str = "eager",
        algo: str = "dreamer_v2", **overrides) -> Dict[str, Any]:
    """Warm-up at τ=1, ``steps`` timed steps at τ=0 (``mode`` eager, or
    graphed: one-sample bursts); returns one side of :func:`compare`."""
    import torch

    from sheeprl_tpu_torch.device import resolve_device
    from sheeprl_tpu_torch.kernels import ops
    from sheeprl_tpu_torch.train.graphs import WARMUP_CALLS

    if mode not in ("eager", "graphed"):
        raise ValueError(f"mode must be eager or graphed, got {mode!r}")
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    # what the caller already holds on the card is not the trainer's
    base_bytes = torch.cuda.memory_allocated(dev) if cuda else 0
    cfg, state, program, data = build_trainer(dev, seed, algo, **overrides)
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    if cuda:  # the peak covers the warm-up and the capture: a graph keeps its step's memory in its own pool
        torch.cuda.reset_peak_memory_stats(dev)
    metrics = program(state, data, tau=1.0)
    stack = {k: v[None] for k, v in data.items()}
    if mode == "graphed":
        step = lambda: program.burst(state, stack, [0.0])  # noqa: E731
        for _ in range(WARMUP_CALLS + 1):  # the capture's eager warm-up calls, then the capture and one replay
            step()
    else:
        step = lambda: program(state, data, tau=0.0)  # noqa: E731
    sync()
    ops.hafner_cell_launches.reset()
    ops.hafner_sequence_launches.reset()
    t0 = time.perf_counter()
    for _ in range(steps):
        metrics = step()
    sync()
    wall_s = time.perf_counter() - t0
    cell_launches, seq_launches = ops.hafner_cell_launches.count, ops.hafner_sequence_launches.count
    losses = {k: float(v) for k, v in metrics.items()}
    result: Dict[str, Any] = {
        "metric": _metric(algo),
        "mode": mode,
        "value": steps / wall_s,
        "unit": "steps/s",
        "steps": steps,
        "batch": [int(cfg.per_rank_sequence_length), int(cfg.per_rank_batch_size)],
        "horizon": int(cfg.algo.horizon),
        "losses": losses,
        "hafner_cell_launches": cell_launches,
        "hafner_cell_launches_by_operand_dtype": dict(ops.hafner_cell_launches.by_variant),
        "hafner_cell_launches_per_step": cell_launches / steps,
        "hafner_sequence_launches": seq_launches,
        "peak_device_memory_bytes": torch.cuda.max_memory_allocated(dev) - base_bytes if cuda else None,
        "reserved_device_memory_bytes": torch.cuda.memory_reserved(dev) if cuda else None,
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
    }
    if mode == "graphed":
        graph = program.static.step
        result["graph"] = {"eager_calls": graph.eager_calls, "replays": graph.replays,
                           "warmup_s": graph.warmup_s, "capture_s": graph.capture_s}
    if profile:
        if not cuda:
            raise RuntimeError("--profile measures the device: it needs a CUDA card")
        prof = profile_steps(step, steps)
        # the profiler slows the host; the device's work is the same, so its
        # busy time over the unprofiled steps' wall time is the idle share those had
        prof["device_idle_share_of_timed_steps"] = 1.0 - prof["device_busy_ms_per_step"] / (1e3 * wall_s / steps)
        result.update(prof)
    del state, program, data, stack
    if cuda:
        torch.cuda.empty_cache()
    return result


def compare(steps: int = 5, device=None, profile: bool = False, seed: int = 0, algo: str = "dreamer_v2",
            **overrides) -> Dict[str, Any]:
    """The eager and the graphed step in one call, each on a fresh trainer."""
    eager = run(steps, device, profile, seed, mode="eager", algo=algo, **overrides)
    graphed = run(steps, device, profile, seed, mode="graphed", algo=algo, **overrides)
    return {"metric": _metric(algo), "eager": eager, "graphed": graphed,
            "graphed_over_eager": graphed["value"] / eager["value"]}


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--algo", default="dreamer_v2", choices=sorted(PRESETS))
    args = ap.parse_args(argv)
    print(json.dumps(compare(args.steps, args.device, args.profile, args.seed, args.algo)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

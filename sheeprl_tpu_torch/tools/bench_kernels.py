"""Forward and backward of the LayerNorm-GRU over a sequence: the sequence
kernel against the plain cell under a loop (counterpart of
``tools/bench_kernels.py``).

    python -m sheeprl_tpu_torch.tools.bench_kernels [--device cuda] [--repeats 5]

At the DV2 shape of the JAX tool, B=16, T=50, H=600, X=400, eps 1e-3: the
same seeded operands and the same loss, ``sum(tanh(hs))``, differentiated in
``h0``, ``xs`` and all four parameters, through

- **kernel**: ``ops.hafner_gru_sequence`` (the CUDA sequence kernel forward,
  its hand-derived VJP backward);
- **plain**: ``reference.hafner_sequence`` (the plain cell under a Python
  loop over T, autograd backward).

Each contender is timed once per round over ``--repeats`` interleaved rounds
after a warm-up call, with the device synchronised around each call; the
median counts. Prints one JSON line: cell-steps per second of the kernel
path, both paths' seconds per call, the speedup, the kernel's forward error
and gradient error against the plain path (TF32 off for both), and the
recurrence variant the kernel path ran (``ops.hafner_sequence_variant``).
Runs on ``cuda`` unless given ``--device cpu`` (where both paths are plain).

:func:`sequence_split` reads one variant's device launches per call and its
time split into the input projection and the recurrence from the
profiler's kernel records.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

B, T, H, X = 16, 50, 600, 400
EPS = 1e-3


def _operands(device):
    import numpy as np
    import torch

    rng = np.random.RandomState(0)
    t = lambda *shape, scale=1.0, shift=0.0: torch.from_numpy(
        (shift + scale * rng.randn(*shape)).astype(np.float32)
    ).to(device)
    return (t(B, H), t(T, B, X), t(H + X, 3 * H, scale=0.05), t(3 * H, scale=0.05),
            t(3 * H, scale=0.05, shift=1.0), t(3 * H, scale=0.05))


def sequence_split(seq_operands, variant: str, eps: float = EPS, calls: int = 10) -> dict:
    """One variant of ``ops.hafner_sequence_cuda`` under ``torch.profiler``
    (``calls`` eager calls recorded after one warm-up call that a schedule
    leaves out): device kernel launches per call, and the device ms per call
    of the input projection (the product kernel launched once a call) and of
    the recurrence (every other kernel), from CUPTI's kernel records, with
    the share of records the profiler kept."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from sheeprl_tpu_torch.kernels import ops
    from sheeprl_tpu_torch.tools.profile_serve import device_us

    fn = lambda: ops.hafner_sequence_cuda(*seq_operands, eps=eps, variant=variant)  # noqa: E731
    fn()
    torch.cuda.synchronize()
    windows = []  # the recorded window's kernel records, handed over when it closes
    on_ready = lambda p: windows.append([(e.key, e.count, device_us(e)) for e in p.key_averages()])  # noqa: E731
    with profile(activities=[ProfilerActivity.CUDA], schedule=schedule(wait=0, warmup=1, active=calls, repeat=1),
                 on_trace_ready=on_ready) as prof:
        for _ in range(calls + 1):
            fn()
            torch.cuda.synchronize()
            prof.step()
    if len(windows) != 1:
        raise RuntimeError(f"sequence_split: the profiler closed {len(windows)} windows, expected 1")
    records = [r for r in windows[0] if r[2] > 0]
    if not records:
        raise RuntimeError("sequence_split: the profiler recorded no kernel")
    # the profiler can drop a few of a window's records (one H100 run kept 7
    # of 10): a kernel's launches a call are its kept records over the calls,
    # rounded, and its time a launch the mean of the kept records
    launches = {key: max(1, round(count / calls)) for key, count, _us in records}
    mean_us = {key: us / count for key, count, us in records}
    has_x = seq_operands[1].shape[2] > 0
    projection = [key for key in launches if has_x and "hafner_product" in key and launches[key] == 1]
    projection_us = mean_us[projection[0]] if len(projection) == 1 else None
    total_us = sum(mean_us[key] * launches[key] for key in launches)
    return {
        "device_launches_per_call": sum(launches.values()),
        "projection_ms": None if projection_us is None else projection_us / 1e3,
        "recurrence_ms": (total_us - (projection_us or 0.0)) / 1e3 if projection_us is not None or not has_x else None,
        "profiled_ms": total_us / 1e3,
        "records_kept": sum(count for _key, count, _us in records) / (calls * max(1, sum(launches.values()))),
        "kernels": {key[:80]: n for key, n in launches.items()},
    }


def run(device=None, repeats: int = 5):
    """One bench run; returns the JSON line's dict."""
    import torch

    from sheeprl_tpu_torch.device import resolve_device
    from sheeprl_tpu_torch.kernels import ops, reference

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        args = _operands(dev)

        def fwd_bwd(seq):
            leaves = [a.detach().requires_grad_(True) for a in args]
            hs = seq(*leaves, eps=EPS)
            return hs.detach(), torch.autograd.grad(torch.tanh(hs).sum(), leaves)

        contenders = {"kernel": lambda: fwd_bwd(ops.hafner_gru_sequence), "plain": lambda: fwd_bwd(reference.hafner_sequence)}
        results = {name: fn() for name, fn in contenders.items()}  # warm-up, and the outputs compared
        runs = {name: [] for name in contenders}
        for _ in range(repeats):
            for name, fn in contenders.items():
                if cuda:
                    torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                fn()
                if cuda:
                    torch.cuda.synchronize(dev)
                runs[name].append(time.perf_counter() - t0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    seconds = {name: statistics.median(r) for name, r in runs.items()}
    (hs, grads), (p_hs, p_grads) = results["kernel"], results["plain"]
    grad_err = max(((g - p).abs().max() / p.abs().max().clamp_min(1e-30)).item() for g, p in zip(grads, p_grads))
    return {
        "metric": "hafner_ln_gru_seq_fwd_bwd_sps",
        "value": B * T / seconds["kernel"],
        "unit": "steps/s",
        "seconds_per_call": seconds,
        "speedup_vs_plain": seconds["plain"] / seconds["kernel"],
        "max_abs_err": (hs - p_hs).abs().max().item(),
        "grad_rel_err": grad_err,
        "variant": ops.hafner_sequence_variant(T, B, H, X, dev)["variant"] if cuda else "plain",
        "shape": {"B": B, "T": T, "H": H, "X": X, "eps": EPS},
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "protocol": (
            f"forward+backward of sum(tanh(hs)) in h0, xs and all parameters at B={B} T={T} H={H} X={X}: "
            f"ops.hafner_gru_sequence vs reference.hafner_sequence, median of {repeats} interleaved rounds "
            "after one warm-up call each, synchronised around each call, TF32 off"
        ),
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    print(json.dumps(run(args.device, args.repeats)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

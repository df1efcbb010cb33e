"""Device time of each kernel of one LayerNorm-GRU step, from the profiler.

    python -m sheeprl_tpu_torch.tools.bench_cell [--batch 1,16,64] [--hidden 600] [--input 400]

For each batch size, runs ``--calls`` eager calls of the CUDA cell under
``torch.profiler`` twice: once back to back (``W`` stays in the 50 MB L2)
and once with a 128 MB write between calls (``W`` comes from device
memory). Prints one JSON line per batch size and mode: the mean device time
per call of every kernel the call ran (the cell and the memset of its
counters) and of the plain PyTorch composition's kernels, from CUPTI's
kernel records, so host launch gaps are out. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess

from sheeprl_tpu_torch.tools.profile_serve import device_us


def _profile(fn, calls: int, flush=None):
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    # the flush's own fill kernel, when there is one, is listed too
    return {e.key[:80]: round(device_us(e) / calls, 3) for e in prof.key_averages() if device_us(e) > 0}


def main() -> int:
    import numpy as np
    import torch

    from sheeprl_tpu_torch.kernels import ops, reference

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", default="1,16,64")
    ap.add_argument("--hidden", type=int, default=600)
    ap.add_argument("--input", type=int, default=400)
    ap.add_argument("--calls", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_cell needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    H, X = args.hidden, args.input
    scratch = torch.empty(32 * 2**20, dtype=torch.float32, device="cuda")  # 128 MB
    for B in (int(b) for b in args.batch.split(",")):
        rng = np.random.RandomState(B)

        def t(*shape, scale=1.0):
            return torch.from_numpy((scale * rng.randn(*shape)).astype(np.float32)).cuda()

        operands = (t(B, H), t(B, X), t(H + X, 3 * H, scale=0.05), t(3 * H), 1.0 + t(3 * H, scale=0.1), t(3 * H))
        for mode, flush in (("l2_warm", None), ("l2_cold", lambda: scratch.fill_(1.0))):
            row = {
                "card": card,
                "B": B,
                "H": H,
                "X": X,
                "mode": mode,
                "kernel_us": _profile(lambda: ops.hafner_cell_cuda(*operands, eps=1e-5), args.calls, flush),
                "plain_us": _profile(lambda: reference.hafner_cell(*operands, eps=1e-5), args.calls, flush),
            }
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

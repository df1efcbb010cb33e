"""Device time of each kernel of one LayerNorm-GRU step, from the profiler.

    python -m sheeprl_tpu_torch.tools.bench_cell [--batch 1,32,64,1600] [--hidden 600] [--input 400]

For each batch size, runs ``--calls`` eager calls under ``torch.profiler``
twice: once back to back (``W`` stays in the 50 MB L2) and once with a
128 MB write between calls (``W`` comes from device memory). Prints one JSON
line per batch size and mode with the mean device time per call, from
CUPTI's kernel records (host launch gaps are out), of:

- the CUDA cell, split into its product kernel and its gate kernel;
- cuBLAS's f32 SGEMM of the same product ``[h|x]·W`` (``torch.matmul``, TF32
  off): the yardstick of the product, never called by the port;
- the plain PyTorch composition, kernel by kernel.

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess

from sheeprl_tpu_torch.tools.profile_serve import device_us


#: profiled windows ``_profile`` takes at most: CUPTI can drop a window's records (one H100 run kept none of a
#: kernel's), and a window is taken again until one keeps every record
WINDOWS = 6


def _profile(fn, calls: int, flush=None):
    """Mean device µs a call of each kernel ``fn`` launches: its kept
    records' mean time times its launches a call (kept records over calls,
    rounded), from the window that kept the most records."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    best = {}
    for _window in range(WINDOWS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                if flush is not None:
                    flush()
                fn()
            torch.cuda.synchronize()
        # the flush's own fill kernel, when there is one, is listed too
        kept = {e.key[:80]: (e.count, device_us(e)) for e in prof.key_averages() if device_us(e) > 0}
        if sum(c for c, _us in kept.values()) > sum(c for c, _us in best.values()):
            best = kept
        if best and all(c % calls == 0 for c, _us in best.values()):
            break
    return {k: round(max(1, round(c / calls)) * us / c, 3) for k, (c, us) in best.items()}


def _sum(records, *, having: str = "", without: str = "") -> float:
    return round(sum(v for k, v in records.items() if having in k and not (without and without in k.lower())), 3)


def operands(B: int, H: int, X: int, seed: int):
    """``(h, x, W, b, ln_scale, ln_bias)`` on the card, seeded with numpy."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)

    def t(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy((shift + scale * rng.randn(*shape)).astype(np.float32)).cuda()

    return t(B, H), t(B, X), t(H + X, 3 * H, scale=0.05), t(3 * H), t(3 * H, scale=0.1, shift=1.0), t(3 * H)


def cell_split(cell_operands, calls: int = 50, flush=None) -> dict:
    """Mean device µs per call of the cell's product and gate kernels and of
    cuBLAS's SGEMM of the same product, from the profiler's kernel records;
    with a bf16 ``x`` (the bf16 operand path) cuBLAS's GEMM of the product on
    bf16 operands."""
    import torch

    from sheeprl_tpu_torch.kernels import ops

    h, x, w = cell_operands[:3]
    if x.dtype == torch.bfloat16:
        h, w = h.to(torch.bfloat16), w.to(torch.bfloat16)
    u = torch.cat([h, x], dim=-1)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        kernel = _profile(lambda: ops.hafner_cell_cuda(*cell_operands, eps=1e-5), calls, flush)
        cublas = _profile(lambda: torch.matmul(u, w), calls, flush)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    product, gates = _sum(kernel, having="hafner_product"), _sum(kernel, having="hafner_gates")
    return {
        "product_us": product,
        "gates_us": gates,
        "cell_us": round(product + gates, 3),
        "cublas_product_us": _sum(cublas, without="fill"),
        "cublas_kernels": {k: v for k, v in cublas.items() if "fill" not in k.lower()},
    }


def main() -> int:
    import torch

    from sheeprl_tpu_torch.kernels import ops, reference

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", default="1,32,64,1600")
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
        cell_operands = operands(B, H, X, seed=B)
        for mode, flush in (("l2_warm", None), ("l2_cold", lambda: scratch.fill_(1.0))):
            row = {
                "card": card,
                "B": B,
                "H": H,
                "X": X,
                "mode": mode,
                "variant": ops.hafner_cell_variant(B, H, X),
                **cell_split(cell_operands, args.calls, flush),
                "plain_us": _profile(lambda: reference.hafner_cell(*cell_operands, eps=1e-5), args.calls, flush),
            }
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Time the kernels built with some of their source's constants changed.

    python -m sheeprl_tpu_torch.tools.bench_variants --set kWideWG=2 --set kWideWG=4 [--batch 64,801,1600]
    python -m sheeprl_tpu_torch.tools.bench_variants --kernel sequence --set kGridSync=0 [--batch 16,64]

Each ``--set NAME=VALUE`` is one variant of ``kernels/csrc/hafner_gru.cu``
with the line ``constexpr <type> NAME = ...;`` given that value. Every
variant is built like the shipped source (``kernels/build.py``, into
``.torch_ext_build/`` under its own digest), held against the plain version
at each batch size (abs 1e-4), and timed with ``chip_smoke.device_ms`` in
interleaved rounds with the shipped build (shipped, variants..., repeated),
so that all of them share one card and one call. ``--kernel cell`` (the
default) times the cell at H=600, X=400; ``--kernel sequence`` times the
sequence's persistent recurrence at T=50, H=600, X=400 (eps 1e-3, the kernel
bench's) and its synchronisation alone (``ops.hafner_sync_floor_cuda``, 100
steps' worth, reported a step): the way to time the grid barrier's build
constant, ``kGridSync``. Prints one JSON line per round, variant and batch
size. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import sys
import tempfile
from pathlib import Path

SEQ_T, SEQ_H, SEQ_X, SEQ_EPS = 50, 600, 400, 1e-3
FLOOR_STEPS = 100


def variant_source(source: str, name: str, value: str) -> str:
    pattern = re.compile(rf"(constexpr\s+\w+\s+{re.escape(name)}\s*=\s*)[^;]+;")
    if not pattern.search(source):
        raise SystemExit(f"no constant {name} in the source")
    return pattern.sub(lambda m: f"{m.group(1)}{value};", source, count=1)


def _sequence_operands(B: int, seed: int):
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    t = lambda *shape, scale=1.0, shift=0.0: torch.from_numpy(  # noqa: E731
        (shift + scale * rng.randn(*shape)).astype(np.float32)
    ).cuda()
    H, X = SEQ_H, SEQ_X
    return (t(B, H), t(SEQ_T, B, X), t(H + X, 3 * H, scale=0.05), t(3 * H, scale=0.05),
            t(3 * H, scale=0.05, shift=1.0), t(3 * H, scale=0.05))


def _time_cell(operands, chip_smoke, ops, reference) -> dict:
    out = ops.hafner_cell_cuda(*operands, eps=1e-5)
    err = (out - reference.hafner_cell(*operands, eps=1e-5)).abs().max().item()
    ms = chip_smoke.device_ms(lambda: ops.hafner_cell_cuda(*operands, eps=1e-5))
    return {"ms": ms, "max_abs_err": err, "ok": err <= 1e-4}


def _time_sequence(operands, chip_smoke, ops, reference) -> dict:
    B = operands[0].shape[0]
    run = lambda: ops.hafner_sequence_cuda(*operands, eps=SEQ_EPS, variant="persistent")  # noqa: E731
    err = (run() - reference.hafner_sequence(*operands, eps=SEQ_EPS)).abs().max().item()
    floor = chip_smoke.device_ms(lambda: ops.hafner_sync_floor_cuda(B, SEQ_H, FLOOR_STEPS))
    return {"ms": chip_smoke.device_ms(run), "sync_floor_us_per_step": 1e3 * floor / FLOOR_STEPS,
            "max_abs_err": err, "ok": err <= 1e-4}


def main() -> int:
    import torch

    root = Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(root))
    import chip_smoke
    from sheeprl_tpu_torch.kernels import build, ops, reference
    from sheeprl_tpu_torch.tools import bench_cell

    ap = argparse.ArgumentParser()
    ap.add_argument("--set", action="append", default=[], metavar="NAME=VALUE")
    ap.add_argument("--kernel", choices=("cell", "sequence"), default="cell")
    ap.add_argument("--batch", default=None, help="batch sizes (cell: 64,801,1600; sequence: 16,64)")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_variants needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()

    shipped = build.SOURCES["hafner_gru"]
    sources = {"shipped": shipped}
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    scratch = Path(tempfile.mkdtemp(dir=build.BUILD_DIR))
    for setting in args.set:
        name, value = setting.split("=", 1)
        path = scratch / f"hafner_gru_{name}_{value}.cu"
        path.write_text(variant_source(shipped.read_text(), name, value))
        sources[setting] = path

    def use(label: str) -> None:
        build.SOURCES["hafner_gru"] = sources[label]
        build.load_library.cache_clear()
        ops._hafner_lib.cache_clear()
        ops._sequence_plan.cache_clear()

    batches = [int(b) for b in (args.batch or ("64,801,1600" if args.kernel == "cell" else "16,64")).split(",")]
    if args.kernel == "cell":
        operands = {B: bench_cell.operands(B, 600, 400, seed=B) for B in batches}
        timed = _time_cell
    else:
        operands = {B: _sequence_operands(B, seed=B) for B in batches}
        timed = _time_sequence
    try:
        for rnd in range(args.rounds):
            for label in sources:
                use(label)
                for B, kernel_operands in operands.items():
                    row = timed(kernel_operands, chip_smoke, ops, reference)
                    print(json.dumps({"card": card, "kernel": args.kernel, "round": rnd, "variant": label, "B": B,
                                      **row}), flush=True)
    finally:
        build.SOURCES["hafner_gru"] = shipped
        shutil.rmtree(scratch, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Time the cell built with some of its source's constants changed.

    python -m sheeprl_tpu_torch.tools.bench_variants --set kWideWG=2 --set kWideWG=4 [--batch 64,801,1600]

Each ``--set NAME=VALUE`` is one variant of ``kernels/csrc/hafner_gru.cu``
with the line ``constexpr <type> NAME = ...;`` given that value. Every
variant is built like the shipped source (``kernels/build.py``, into
``.torch_ext_build/`` under its own digest), held against the plain version
at each batch size (abs 1e-4), and timed with ``chip_smoke.device_ms`` in
interleaved rounds with the shipped build (shipped, variants..., repeated),
so that all of them share one card and one call. Prints one JSON line per
round and batch size. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import sys
import tempfile
from pathlib import Path


def variant_source(source: str, name: str, value: str) -> str:
    pattern = re.compile(rf"(constexpr\s+\w+\s+{re.escape(name)}\s*=\s*)[^;]+;")
    if not pattern.search(source):
        raise SystemExit(f"no constant {name} in the source")
    return pattern.sub(lambda m: f"{m.group(1)}{value};", source, count=1)


def main() -> int:
    import torch

    root = Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(root))
    import chip_smoke
    from sheeprl_tpu_torch.kernels import build, ops, reference
    from sheeprl_tpu_torch.tools import bench_cell

    ap = argparse.ArgumentParser()
    ap.add_argument("--set", action="append", default=[], metavar="NAME=VALUE")
    ap.add_argument("--batch", default="64,801,1600")
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

    operands = {B: bench_cell.operands(B, 600, 400, seed=B) for B in (int(b) for b in args.batch.split(","))}
    try:
        for rnd in range(args.rounds):
            for label in sources:
                use(label)
                for B, cell_operands in operands.items():
                    out = ops.hafner_cell_cuda(*cell_operands, eps=1e-5)
                    err = (out - reference.hafner_cell(*cell_operands, eps=1e-5)).abs().max().item()
                    ms = chip_smoke.device_ms(lambda: ops.hafner_cell_cuda(*cell_operands, eps=1e-5))
                    print(json.dumps({"card": card, "round": rnd, "variant": label, "B": B, "ms": ms,
                                      "max_abs_err": err, "ok": err <= 1e-4}), flush=True)
    finally:
        build.SOURCES["hafner_gru"] = shipped
        shutil.rmtree(scratch, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

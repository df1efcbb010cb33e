"""Where one step of the persistent recurrence spends its time, phase by phase.

    python -m sheeprl_tpu_torch.tools.profile_sequence [--batch 16,64] [--step 10]

Builds a copy of ``kernels/csrc/hafner_gru.cu`` with ``clock64()`` stamps at
the phase boundaries of ``hafner_recurrence_kernel`` (thread 0 of every
block, at step ``--step``), beside the shipped library in
``.torch_ext_build/``, and runs the persistent sequence at T=50, H=600,
X=400 (eps 1e-3, the kernel bench's shape) for each batch size. Prints one
JSON line per batch size with the card line, the instrumented build's device
time per call (``chip_smoke.device_ms``) and, per phase, the median over
blocks of its SM cycles:

- ``zx_issue``: the loads of zx[t] (issued, not waited for);
- ``stage_h``: h_{t-1}'s K slice from L2 into the B operand, split into TF32
  hi and lo, and the block barrier;
- ``wgmma``: the warpgroups' products and their sum into the partial tile;
- ``cluster_sync``: the cluster barrier before the partials are read;
- ``reduce_stats``: the four partials over distributed shared memory, zx and
  the bias, the group's LayerNorm partial published;
- ``grid_sync1``, ``grid_sync2``: the two grid barriers;
- ``merge_gates``: the row statistics merged, the affine, the gates, h_t out.

Each phase's stamp waits for nothing but thread 0's own work, so a phase's
cycles include waiting for the slowest warp of its block only where a barrier
closes it. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
from pathlib import Path

T, H, X, EPS = 50, 600, 400, 1e-3
# (stamp index, the source line it goes in front of)
MARKS = [
    (0, "    // zx[t]'s first partial plane"),
    (1, "    // h_{t-1}'s K slice as the B operand"),
    (2, "    // this block's partial z^T [64 x NT] over its K slice, 3xTF32: every"),
    (3, "    cluster.sync();  // the cluster's four partials are written and visible"),
    (4, "    // z of this warp's row: the four K slices'"),
    (5, "    if (norm) {\n      grid_sync(barrier);  // every group's"),
    (6, "    // the row's LayerNorm statistics from the groups'"),
    (7, "    if (t + 1 < T) grid_sync(barrier);"),
]
PHASES = ["zx_issue", "stage_h", "wgmma", "cluster_sync", "reduce_stats", "grid_sync1", "merge_gates", "grid_sync2"]
MAX_BLOCKS = 512


def instrumented_source(source: str, step: int) -> str:
    """The source with a stamp before each of MARKS and after the last."""
    for k, anchor in MARKS:
        if source.count(anchor) != 1:
            raise SystemExit(f"profile_sequence: the source no longer has exactly one {anchor.strip()!r}")
        source = source.replace(anchor, f"    PHASE_STAMP({k});\n" + anchor)
    last = MARKS[-1][1]
    source = source.replace(last, f"{last}\n    PHASE_STAMP({len(MARKS)});")
    source = source.replace(
        "namespace {\n",
        f"namespace {{\n__device__ long long g_phase_stamps[{MAX_BLOCKS}][{len(MARKS) + 1}];\n"
        f"#define PHASE_STAMP(k) do {{ if (threadIdx.x == 0 && t == {step}) "
        "g_phase_stamps[blockIdx.x][k] = clock64(); } while (0)\n",
        1,
    )
    return source + (
        '\nextern "C" int hafner_phase_stamps(long long* out) {\n'
        "  return static_cast<int>(cudaMemcpyFromSymbol(out, g_phase_stamps, sizeof(g_phase_stamps)));\n}\n"
    )


def main() -> int:
    import torch

    root = Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(root))
    import chip_smoke
    from sheeprl_tpu_torch.kernels import build, ops
    from sheeprl_tpu_torch.tools.bench_variants import _sequence_operands

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", default="16,64")
    ap.add_argument("--step", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_sequence needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()

    shipped = build.SOURCES["hafner_gru"]
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = build.BUILD_DIR / "hafner_gru_phase_stamps.cu"
    path.write_text(instrumented_source(shipped.read_text(), args.step))
    build.SOURCES["hafner_gru"] = path
    build.load_library.cache_clear()
    ops._hafner_lib.cache_clear()
    ops._sequence_plan.cache_clear()
    try:
        lib = ops._hafner_lib()
        lib.hafner_phase_stamps.argtypes = [ctypes.c_void_p]
        lib.hafner_phase_stamps.restype = ctypes.c_int
        stride = len(MARKS) + 1
        for B in (int(b) for b in args.batch.split(",")):
            operands = _sequence_operands(B, seed=B)
            run = lambda: ops.hafner_sequence_cuda(*operands, eps=EPS, variant="persistent")  # noqa: E731
            ms = chip_smoke.device_ms(run)
            run()
            torch.cuda.synchronize()
            stamps = (ctypes.c_longlong * (MAX_BLOCKS * stride))()
            if lib.hafner_phase_stamps(ctypes.addressof(stamps)) != 0:
                raise RuntimeError("profile_sequence: could not read the stamps")
            blocks = ops.sequence_shape(B, H)["blocks"]
            rows = [stamps[b * stride:(b + 1) * stride] for b in range(blocks)]
            cycles = {name: statistics.median(r[k + 1] - r[k] for r in rows) for k, name in enumerate(PHASES)}
            cycles["step"] = statistics.median(r[-1] - r[0] for r in rows)
            print(json.dumps({"card": card, "T": T, "B": B, "H": H, "X": X, "step": args.step,
                              "instrumented_ms": ms, "median_cycles_over_blocks": cycles}), flush=True)
    finally:
        build.SOURCES["hafner_gru"] = shipped
        build.load_library.cache_clear()
        ops._hafner_lib.cache_clear()
        ops._sequence_plan.cache_clear()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

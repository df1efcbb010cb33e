"""The per-family binding-constraint table (counterpart of
``tools/roofline_report.py``).

    python -m sheeprl_tpu_torch.tools.roofline_report                 # default families, tiny, on the card
    python -m sheeprl_tpu_torch.tools.roofline_report --full --json roofline.json
    python -m sheeprl_tpu_torch.tools.roofline_report --families dv1 sac --device cpu
    python -m sheeprl_tpu_torch.tools.roofline_report --dry-run       # compose and resolve only
    python -m sheeprl_tpu_torch.tools.roofline_report --full --families dv3 --probes   # the learn probes' cost

For every profiled family (DV1, DV2, DV3, P2E-DV3, SAC and PPO by default;
P2E-DV1 and P2E-DV2 on request) this builds the real train step on
synthetic data (``sheeprl_tpu_torch.obs.prof.harness``), warms it past its
CUDA-graph capture, profiles ``--steps`` runs with ``torch.profiler``,
attributes the device time to the step (``obs/prof/trace.py``), divides the
step's counted FLOPs and bytes by it and prints one table row: device ms a
gradient step, MFU (against the bf16 peak), the FLOP rate's share of the
peak of the step's own compute type (f32, TF32 or bf16), achieved bandwidth
and its share of the peak, the device's busy share of the window, and the
compute- / memory- / dispatch-bound verdict: the larger of the compute
type's share and the bandwidth's. The bytes are an unfused upper bound
(every PyTorch operation's inputs and outputs), so a memory-bound verdict
leans on the byte model. ``--json`` writes the
records. ``--dry-run`` composes every family's config and resolves its
builders without building or stepping anything. ``--probes`` builds each
step with the learn probes in it (``obs/learn``, a sentinel installed as a
``metric.telemetry.learn.enabled`` run has): its device time against a run
without is the probes' device cost; ``--probe-pulls N`` pulls them to the
host every N-th run instead of after each (``learn.every_n_bursts``).

The card's name and power limit (``nvidia-smi``) head the table; every
number in it belongs beside them.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import Any, Dict, List, Optional

#: the ROADMAP item-4 set; order is the table order
DEFAULT_FAMILIES = ("dv1", "dv2", "dv3", "p2e_dv3", "sac", "ppo")


def dry_run(families) -> int:
    """Compose and resolve every family's builder without building it."""
    import importlib

    from sheeprl_tpu_torch.obs.prof.harness import ALGOS, FAMILIES, PRESETS, _compose, tiny_overrides
    from sheeprl_tpu_torch.obs.prof.roofline import detect_peaks

    failures = []
    for family in families:
        try:
            preset, exp = FAMILIES[family]
            if family in ("sac", "ppo"):
                cfg = _compose(exp, tiny_overrides(family))
                module = f"sheeprl_tpu_torch.algos.{family}.{family}"
            else:
                from sheeprl_tpu_torch import configs

                cfg = configs.dreamer_v2_config(PRESETS[preset][1], **tiny_overrides(family))
                module = ALGOS[PRESETS[preset][0]][1]
            assert cfg.per_rank_batch_size > 0
            assert hasattr(importlib.import_module(module), "build_train_fn") or family == "ppo", family
        except Exception as exc:
            failures.append(f"{family}: {type(exc).__name__}: {exc}")
    peaks = detect_peaks()
    print(f"roofline dry-run: peaks {peaks['label']} ({peaks['peak_tflops']} TFLOP/s, {peaks['peak_gbps']} GB/s)")
    if failures:
        print("roofline dry-run FAILED:")
        for f in failures:
            print(f"  {f}")
        return 1
    print(f"roofline dry-run OK ({len(list(families))} families compose and resolve)")
    return 0


def profile_family(family: str, steps: int = 5, tiny: bool = False, device=None,
                   overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Build, warm up, profile ``steps`` runs, attribute, roofline: the
    ``obs.prof.capture.analyze_trace`` record of one gradient step (plus
    ``family``, the step's counted FLOPs and bytes, and the profiled
    window's step calls)."""
    import torch

    from sheeprl_tpu_torch.obs.prof.capture import analyze_trace, profiler_activities
    from sheeprl_tpu_torch.obs.prof.harness import build_harness
    from sheeprl_tpu_torch.obs.prof.roofline import compute_dtype, detect_peaks
    from sheeprl_tpu_torch.obs.prof.trace import events_from_profiler

    harness = build_harness(family, overrides=overrides, tiny=tiny, device=device)
    cost = harness.cost() or {}
    harness.warm_up()
    with torch.profiler.profile(activities=profiler_activities()) as prof:
        harness.run(steps)
    record = analyze_trace(
        events_from_profiler(prof), flops_per_step=cost.get("flops"), bytes_per_step=cost.get("bytes_accessed"),
        peaks=detect_peaks(device=harness.device), device=harness.device,
        compute_dtype=compute_dtype(getattr(getattr(harness.cfg, "fabric", None), "precision", None)),
    )
    record.update(family=family, flops_per_step=cost.get("flops"), bytes_per_step=cost.get("bytes_accessed"),
                  step_calls=steps * harness.calls_per_run, unit="ms per gradient step (one step call)")
    return record


def fmt_row(family: str, rec: Dict[str, Any]) -> str:
    if rec.get("error"):
        return f"| {family} | — | — | — | — | — | error: {rec['error'][:60]} |"
    ms, mfu, cu, bw, bwu, busy = (rec.get(k) for k in ("device_ms_per_step", "mfu_device_pct", "compute_util_pct",
                                                         "achieved_gbps", "bandwidth_util_pct", "busy_frac"))
    dash = lambda v: "—" if v is None else v  # noqa: E731
    return (f"| {family} | {dash(ms)} | {dash(mfu)} | {dash(cu)} ({rec.get('compute_dtype')}, "
            f"{rec.get('compute_peak_tflops')} TFLOP/s) | {dash(bw)}" + (f" ({bwu}%)" if bwu is not None else "")
            + f" | {dash(busy)} | {rec.get('roofline_verdict', '—')} |")


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit``, or ``cpu``."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60).stdout.strip()
        return out.splitlines()[0] if out else "cpu"
    except (OSError, subprocess.SubprocessError):
        return "cpu"


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--families", nargs="*", default=list(DEFAULT_FAMILIES))
    parser.add_argument("--steps", type=int, default=5, help="profiled runs a family")
    parser.add_argument("--full", action="store_true", help="the presets' widths (default: the tiny CPU-scale ones)")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("--json", default=None, help="write the records to this path")
    parser.add_argument("--dry-run", action="store_true", help="compose and resolve every family, build nothing")
    parser.add_argument("-o", "--override", action="append", default=[], help="config override k=v (repeatable)")
    parser.add_argument("--probes", action="store_true", help="build the steps with the learn probes in them")
    parser.add_argument("--probe-pulls", type=int, default=1, metavar="N",
                        help="with --probes, pull the probes to the host every N-th burst (the sentinel's "
                             "metric.telemetry.learn.every_n_bursts; a run is a burst)")
    args = parser.parse_args(argv)

    if args.dry_run:
        return dry_run(args.families)

    from sheeprl_tpu_torch.config.engine import yaml_load
    from sheeprl_tpu_torch.obs.prof.roofline import detect_peaks

    overrides = {k: yaml_load(v) for k, v in (o.split("=", 1) for o in args.override)}
    peaks = detect_peaks(device=args.device)
    records: Dict[str, Any] = {}
    if args.probes:
        from sheeprl_tpu_torch.obs import learn

        learn.install(learn.LearnSentinel({"every_n_bursts": args.probe_pulls}))
    try:
        for family in args.families:
            print(f"# profiling {family} ...", file=sys.stderr, flush=True)
            try:
                records[family] = profile_family(family, args.steps, not args.full, args.device, overrides)
            except Exception as exc:
                records[family] = {"family": family, "error": f"{type(exc).__name__}: {exc}"}
    finally:
        if args.probes:
            learn.install(None)
    card = card_line()
    scale = ("preset widths" if args.full else "tiny widths") + (
        f", the learn probes on (a pull every {args.probe_pulls} bursts)" if args.probes else "")
    print(f"\n## Roofline: {card}; peaks {peaks['label']} ({peaks['peak_tflops']} TFLOP/s, {peaks['peak_gbps']} GB/s"
          + (", estimated" if peaks.get("estimated") else "") + f"); {scale}, {args.steps} runs a family\n")
    print("| family | device ms / gradient step | MFU % (bf16 peak) | compute share % (type, its peak) "
          "| achieved GB/s (share of peak) | busy share | bound by |")
    print("|---|---|---|---|---|---|---|")
    for family in args.families:
        print(fmt_row(family, records[family]))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "peaks": peaks, "scale": scale, "records": records}, f, indent=2, default=str)
            f.write("\n")
        print(f"\nrecords written to {args.json}", file=sys.stderr)
    return 0 if all(not r.get("error") for r in records.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())

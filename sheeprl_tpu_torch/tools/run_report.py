"""Unified run report: one ``report.md`` per run from the run's artifacts
(counterpart of the JAX package's ``tools/run_report.py``; the same report).

A finished (or still-running) run directory accumulates observability
artifacts that each tell a slice of the story:

- ``telemetry.json``          — the end-of-run summary (``obs/telemetry.py``),
  including the learning-health plane (``learn_warnings``,
  ``learn_criticals``, the sentinel's ``learn`` sub-dict);
- ``telemetry/live.json``     — the last live snapshot (rolling rates);
- ``telemetry/prof/capture_<step>.json`` — in-run roofline captures;
- ``telemetry/flight_*.json`` — flight-recorder evidence dumps (their
  profiler windows' ``*_trace_summary.json`` parses are not dumps);
- ``eval.json`` / ``eval_<k>.json`` — the frozen-policy eval verdicts;
- ``telemetry/sidecar_evalproc.json`` — the in-run eval curve;
- ``.hydra/config.yaml``      — the composed run config.

This tool fuses them into one human-readable ``report.md`` (and, with
``--json``, a machine-readable ``report.json``) so "how did this run go" is
a single document instead of six files and a grep. ``--compare RUN_B``
diffs two runs' learning-health sections — the quickest way to see that run
A went unstable where run B stayed clean (exit code 1 when it did).

Usage::

    python -m sheeprl_tpu_torch.tools.run_report <run_dir> [--out report.md] [--json]
    python -m sheeprl_tpu_torch.tools.run_report <run_dir> --compare <other_run_dir>

Standard library and the port's YAML reader only; every artifact is
optional — missing pieces render as "not recorded", never as a crash
(report generation must work on a half-finished or crashed run, which is
exactly when you want the report).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import time
from typing import Any, Dict, List, Optional

# ---------------------------------------------------------------------------
# artifact loading
# ---------------------------------------------------------------------------


def load_json(path: str) -> Optional[Dict[str, Any]]:
    try:
        with open(path) as f:
            doc = json.load(f)
        return doc if isinstance(doc, dict) else None
    except (OSError, json.JSONDecodeError):
        return None


def load_config(run_dir: str) -> Dict[str, Any]:
    path = os.path.join(run_dir, ".hydra", "config.yaml")
    try:
        from sheeprl_tpu_torch.config.yamlite import load

        with open(path) as f:
            doc = load(f.read())
        return doc if isinstance(doc, dict) else {}
    except Exception:
        return {}


def collect(run_dir: str) -> Dict[str, Any]:
    """Gather every artifact the run dir has; absent ones are None/empty."""
    tel_dir = os.path.join(run_dir, "telemetry")
    captures = []
    for path in sorted(
        glob.glob(os.path.join(tel_dir, "prof", "capture_*.json")),
        key=lambda p: int(re.search(r"capture_(\d+)", p).group(1)),
    ):
        doc = load_json(path)
        if doc is not None:
            doc["_file"] = os.path.basename(path)
            captures.append(doc)
    flights = []
    for path in sorted(glob.glob(os.path.join(tel_dir, "flight_*.json"))):
        if path.endswith("_summary.json"):
            continue
        doc = load_json(path) or {}
        m = re.match(r"flight_(.+?)_(\d+)", os.path.basename(path))
        flights.append(
            {
                "file": os.path.basename(path),
                "reason": m.group(1) if m else "unknown",
                "step": int(m.group(2)) if m else None,
                "wall_time": doc.get("wall_time"),
            }
        )
    evals = []
    for path in sorted(glob.glob(os.path.join(run_dir, "eval*.json"))):
        doc = load_json(path)
        if doc is not None:
            doc["_file"] = os.path.basename(path)
            evals.append(doc)
    sidecars = {}
    for path in glob.glob(os.path.join(tel_dir, "sidecar_*.json")):
        name = re.sub(r"^sidecar_|\.json$", "", os.path.basename(path))
        doc = load_json(path)
        if doc is not None:
            sidecars[name] = doc
    return {
        "run_dir": os.path.abspath(run_dir),
        "summary": load_json(os.path.join(run_dir, "telemetry.json")),
        "live": load_json(os.path.join(tel_dir, "live.json")),
        "captures": captures,
        "flights": flights,
        "evals": evals,
        "sidecars": sidecars,
        "config": load_config(run_dir),
    }


# ---------------------------------------------------------------------------
# report assembly (machine-readable first; markdown renders from this)
# ---------------------------------------------------------------------------


def _get(doc: Optional[Dict[str, Any]], *keys: str, default: Any = None) -> Any:
    cur: Any = doc
    for k in keys:
        if not isinstance(cur, dict):
            return default
        cur = cur.get(k)
    return cur if cur is not None else default


def build_report(art: Dict[str, Any]) -> Dict[str, Any]:
    s = art["summary"] or {}
    cfg = art["config"]
    learn = s.get("learn") if isinstance(s.get("learn"), dict) else {}
    learn_flights = [f for f in art["flights"] if f["reason"] == "learn_divergence"]
    last_cap = art["captures"][-1] if art["captures"] else None
    final_eval = art["evals"][-1] if art["evals"] else None
    inrun = art["sidecars"].get("evalproc") or {}
    report = {
        "run_dir": art["run_dir"],
        "generated_at": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "run": {
            "algo": _get(cfg, "algo", "name"),
            "env": _get(cfg, "env", "id"),
            "seed": cfg.get("seed"),
            "run_wall_s": s.get("run_wall_s"),
            "policy_steps": s.get("policy_steps"),
            "train_steps": s.get("train_steps"),
            "sps": s.get("sps"),
            "sps_train": s.get("sps_train"),
            "mfu": s.get("mfu"),
            "crashed": bool(s.get("crashed", False)),
            "exception": s.get("exception"),
        },
        "learning_health": {
            "warnings": s.get("learn_warnings"),
            "criticals": s.get("learn_criticals"),
            "grad_norm_p95": s.get("grad_norm_p95"),
            "update_ratio_p50": s.get("update_ratio_p50"),
            "bursts_observed": learn.get("bursts_observed"),
            "first_nonfinite_ts": learn.get("first_nonfinite_ts"),
            "events": list(learn.get("events") or []),
            "probes": dict(learn.get("probes") or {}),
            "flight_dumps": [f["file"] for f in learn_flights],
        },
        "phase_percentiles": dict(s.get("phase_percentiles") or {}),
        "roofline": {
            "device_ms_per_step": s.get("device_ms_per_step"),
            "mfu_device_pct": s.get("mfu_device_pct"),
            "verdict": s.get("roofline_verdict"),
            "captures": len(art["captures"]),
            "last_capture": (
                {
                    k: last_cap.get(k)
                    for k in (
                        "_file",
                        "device_ms_per_step",
                        "mfu_device_pct",
                        "roofline_verdict",
                    )
                }
                if last_cap
                else None
            ),
        },
        "eval": {
            "final": (
                {
                    k: final_eval.get(k)
                    for k in ("_file", "mean", "std", "episodes", "protocol", "returns")
                    if k in final_eval
                }
                if final_eval
                else None
            ),
            "inrun_rounds": inrun.get("rounds"),
            "inrun_last_mean": inrun.get("last_mean"),
            "inrun_points": list(inrun.get("points") or [])[-20:],
        },
        "health": {
            "stalls": s.get("stalls"),
            "recompiles": s.get("recompiles"),
            "compile_secs": s.get("compile_secs"),
            "nonfinite_metrics": s.get("nonfinite_metrics"),
            "flight_dumps": s.get("flight_dumps"),
            "flights": art["flights"],
            "ckpt_saves": s.get("ckpt_saves"),
            "ckpt_failures": s.get("ckpt_failures"),
            "env_worker_restarts": s.get("env_worker_restarts"),
        },
        "has_summary": art["summary"] is not None,
    }
    return report


# ---------------------------------------------------------------------------
# markdown rendering
# ---------------------------------------------------------------------------


def _fmt(v: Any) -> str:
    if v is None:
        return "—"
    if isinstance(v, bool):
        return "yes" if v else "no"
    if isinstance(v, float):
        if v == 0:
            return "0"
        return f"{v:.4g}"
    return str(v)


def _table(rows: List[List[Any]], header: List[str]) -> List[str]:
    out = ["| " + " | ".join(header) + " |", "|" + "---|" * len(header)]
    for row in rows:
        out.append("| " + " | ".join(_fmt(c) for c in row) + " |")
    return out


def render_markdown(rep: Dict[str, Any]) -> str:
    run = rep["run"]
    lh = rep["learning_health"]
    roof = rep["roofline"]
    ev = rep["eval"]
    health = rep["health"]
    lines: List[str] = []
    title = run.get("algo") or os.path.basename(rep["run_dir"])
    lines.append(f"# Run report — {title}")
    lines.append("")
    lines.append(f"- run dir: `{rep['run_dir']}`")
    lines.append(f"- generated: {rep['generated_at']}")
    if not rep["has_summary"]:
        lines.append("")
        lines.append(
            "> **No `telemetry.json` found** — the run crashed before "
            "finalize or telemetry was disabled. Sections below cover "
            "whatever artifacts exist."
        )
    lines.append("")

    lines.append("## Run")
    lines.append("")
    lines += _table(
        [
            ["algo", run.get("algo")],
            ["env", run.get("env")],
            ["seed", run.get("seed")],
            ["wall time (s)", run.get("run_wall_s")],
            ["policy steps", run.get("policy_steps")],
            ["train steps", run.get("train_steps")],
            ["sps", run.get("sps")],
            ["sps (train)", run.get("sps_train")],
            ["MFU (%)", run.get("mfu")],
            ["crashed", run.get("crashed")],
        ],
        ["field", "value"],
    )
    if run.get("exception"):
        lines.append("")
        lines.append(f"Exception: `{run['exception']}`")
    lines.append("")

    lines.append("## Learning health")
    lines.append("")
    verdict = "clean"
    if (lh.get("criticals") or 0) > 0:
        verdict = "CRITICAL — divergence events fired"
    elif (lh.get("warnings") or 0) > 0:
        verdict = "warnings — excursions observed, no sustained explosion"
    elif lh.get("bursts_observed") is None:
        verdict = "not instrumented (learn plane off or no training happened)"
    lines.append(f"**Verdict: {verdict}**")
    lines.append("")
    lines += _table(
        [
            ["warn events", lh.get("warnings")],
            ["critical events", lh.get("criticals")],
            ["grad_norm p95", lh.get("grad_norm_p95")],
            ["update_ratio p50", lh.get("update_ratio_p50")],
            ["bursts observed", lh.get("bursts_observed")],
            ["first non-finite ts", lh.get("first_nonfinite_ts")],
        ],
        ["field", "value"],
    )
    events = lh.get("events") or []
    if events:
        lines.append("")
        lines.append("### Events")
        lines.append("")
        lines += _table(
            [
                [
                    e.get("severity"),
                    e.get("reason"),
                    e.get("probe"),
                    e.get("value"),
                    e.get("z"),
                    e.get("step"),
                ]
                for e in events[:32]
            ],
            ["severity", "reason", "probe", "value", "z", "step"],
        )
    if lh.get("flight_dumps"):
        lines.append("")
        lines.append(
            "Flight-recorder divergence dumps: "
            + ", ".join(f"`{f}`" for f in lh["flight_dumps"])
        )
    probes = lh.get("probes") or {}
    if probes:
        lines.append("")
        lines.append("### Probe baselines")
        lines.append("")
        lines += _table(
            [
                [k, v.get("n"), v.get("last"), v.get("p50"), v.get("p95"), v.get("max")]
                for k, v in sorted(probes.items())
                if isinstance(v, dict)
            ],
            ["probe", "n", "last", "p50", "p95", "max"],
        )
    lines.append("")

    lines.append("## Phase percentiles (ms)")
    lines.append("")
    phases = rep.get("phase_percentiles") or {}
    if phases:
        lines += _table(
            [
                [k, v.get("p50"), v.get("p95"), v.get("p99"), v.get("count")]
                for k, v in sorted(phases.items())
                if isinstance(v, dict)
            ],
            ["phase", "p50", "p95", "p99", "count"],
        )
    else:
        lines.append("not recorded")
    lines.append("")

    lines.append("## Roofline")
    lines.append("")
    if roof.get("verdict") or roof.get("captures"):
        lines += _table(
            [
                ["verdict", roof.get("verdict")],
                ["device ms / step", roof.get("device_ms_per_step")],
                ["MFU vs device time (%)", roof.get("mfu_device_pct")],
                ["in-run captures", roof.get("captures")],
            ],
            ["field", "value"],
        )
        if roof.get("last_capture"):
            lines.append("")
            lines.append(f"Last capture: `{roof['last_capture'].get('_file')}`")
    else:
        lines.append("no profile captures this run (`metric.telemetry.profile` off)")
    lines.append("")

    lines.append("## Evaluation")
    lines.append("")
    if ev.get("final"):
        f = ev["final"]
        lines.append(
            f"Final frozen-policy eval (`{f.get('_file')}`): "
            f"mean **{_fmt(f.get('mean'))}** ± {_fmt(f.get('std'))} "
            f"over {_fmt(f.get('episodes'))} episode(s)"
        )
    else:
        lines.append("no `eval.json` recorded")
    if ev.get("inrun_rounds"):
        lines.append("")
        lines.append(
            f"In-run eval: {ev['inrun_rounds']} round(s), "
            f"last mean {_fmt(ev.get('inrun_last_mean'))}"
        )
        pts = ev.get("inrun_points") or []
        if pts:
            lines.append("")
            lines += _table(
                [
                    [p.get("policy_version"), p.get("mean"), p.get("std"), p.get("eval_wall_s")]
                    for p in pts
                ],
                ["policy version", "mean", "std", "eval wall (s)"],
            )
    lines.append("")

    lines.append("## Health")
    lines.append("")
    lines += _table(
        [
            ["stall episodes", health.get("stalls")],
            ["recompiles", health.get("recompiles")],
            ["compile seconds", health.get("compile_secs")],
            ["non-finite metrics", health.get("nonfinite_metrics")],
            ["flight dumps", health.get("flight_dumps")],
            ["checkpoint saves", health.get("ckpt_saves")],
            ["checkpoint failures", health.get("ckpt_failures")],
            ["env worker restarts", health.get("env_worker_restarts")],
        ],
        ["field", "value"],
    )
    flights = health.get("flights") or []
    if flights:
        lines.append("")
        lines += _table(
            [[f["file"], f["reason"], f["step"]] for f in flights],
            ["dump", "reason", "step"],
        )
    lines.append("")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# compare mode
# ---------------------------------------------------------------------------

#: learning-health keys diffed by --compare; (label, lower_is_better)
_COMPARE_KEYS = [
    ("warnings", "warn events", True),
    ("criticals", "critical events", True),
    ("grad_norm_p95", "grad_norm p95", True),
    ("update_ratio_p50", "update_ratio p50", None),  # directionless
]


def render_compare(rep_a: Dict[str, Any], rep_b: Dict[str, Any]) -> str:
    a, b = rep_a["learning_health"], rep_b["learning_health"]
    name_a = os.path.basename(rep_a["run_dir"]) or "A"
    name_b = os.path.basename(rep_b["run_dir"]) or "B"
    lines = [
        "# Learning-health comparison",
        "",
        f"- A: `{rep_a['run_dir']}`",
        f"- B: `{rep_b['run_dir']}`",
        "",
    ]
    rows = []
    flags: List[str] = []
    for key, label, lower_better in _COMPARE_KEYS:
        va, vb = a.get(key), b.get(key)
        note = ""
        if isinstance(va, (int, float)) and isinstance(vb, (int, float)):
            if lower_better and va > vb:
                note = f"A worse ({name_a} flagged)"
            elif lower_better and vb > va:
                note = f"B worse ({name_b} flagged)"
        rows.append([label, va, vb, note])
    lines += _table(rows, ["metric", name_a, name_b, "flag"])
    crit_a, crit_b = a.get("criticals") or 0, b.get("criticals") or 0
    warn_a, warn_b = a.get("warnings") or 0, b.get("warnings") or 0
    lines.append("")
    if crit_a > crit_b or (crit_a == crit_b and warn_a > warn_b):
        lines.append(
            f"**Verdict: `{name_a}` is the unstable run** "
            f"({crit_a} critical / {warn_a} warn vs {crit_b} / {warn_b})."
        )
        flags.append(name_a)
    elif crit_b > crit_a or warn_b > warn_a:
        lines.append(
            f"**Verdict: `{name_b}` is the unstable run** "
            f"({crit_b} critical / {warn_b} warn vs {crit_a} / {warn_a})."
        )
        flags.append(name_b)
    else:
        lines.append("**Verdict: no learning-health difference between the runs.**")
    ev_a = len(a.get("events") or [])
    ev_b = len(b.get("events") or [])
    if ev_a or ev_b:
        lines.append("")
        lines.append(f"Events on record: {name_a}={ev_a}, {name_b}={ev_b}.")
    lines.append("")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_dir", help="run directory (holds telemetry.json et al.)")
    ap.add_argument("--out", default=None, help="report path (default <run_dir>/report.md)")
    ap.add_argument(
        "--json",
        action="store_true",
        help="also write the machine-readable report.json next to report.md",
    )
    ap.add_argument(
        "--compare",
        metavar="RUN_B",
        default=None,
        help="diff this run's learning health against another run dir",
    )
    args = ap.parse_args(argv)

    if not os.path.isdir(args.run_dir):
        print(f"run_report: not a directory: {args.run_dir}", file=sys.stderr)
        return 2
    rep = build_report(collect(args.run_dir))

    if args.compare:
        if not os.path.isdir(args.compare):
            print(f"run_report: not a directory: {args.compare}", file=sys.stderr)
            return 2
        rep_b = build_report(collect(args.compare))
        text = render_compare(rep, rep_b)
        print(text)
        # non-zero when the comparison flagged a diverging run
        return 1 if "is the unstable run" in text else 0

    out = args.out or os.path.join(args.run_dir, "report.md")
    text = render_markdown(rep)
    with open(out, "w") as f:
        f.write(text + "\n")
    print(f"run_report: wrote {out}")
    if args.json:
        json_path = os.path.splitext(out)[0] + ".json"
        with open(json_path, "w") as f:
            json.dump(rep, f, indent=2, sort_keys=True)
        print(f"run_report: wrote {json_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

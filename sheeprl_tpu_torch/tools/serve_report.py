#!/usr/bin/env python
"""Serving SLO report: one ``serve_report.md`` per gateway obs dir
(counterpart of the JAX package's ``tools/serve_report.py``: the same
sections, JSON and exit codes).

A gateway with the ops surface on (``serve.trace_sample_rate``,
``serve.slo.enabled``, ``serve.access_log_sample_rate``,
``serve.metrics_port``) leaves its evidence in one directory
(``serve.obs_dir``):

- ``serve_live.json``: the final ops snapshot (stage percentiles, requests
  and latency by version, batch occupancy, the SLO engine's burn rates and
  verdicts);
- ``alerts.jsonl``: every burn-rate alert transition (fire and clear);
- ``access.jsonl``: the sampled access log;
- ``trace_serve_*.jsonl``: the client and gateway lanes of the sampled
  requests' span chains (``trace_view.py`` merges them).

This tool fuses them into one verdict-led document and **exits 1 when any
objective's verdict is FAIL**. Every artifact is optional; a missing one
renders as "not recorded". It imports nothing but the standard library.

Usage::

    python -m sheeprl_tpu_torch.tools.serve_report <obs_dir> [--out serve_report.md] [--json]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
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


def load_jsonl(path: str, limit: int = 0) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    try:
        with open(path) as f:
            for raw in f:
                raw = raw.strip()
                if not raw:
                    continue
                try:
                    doc = json.loads(raw)
                except json.JSONDecodeError:
                    continue  # a torn tail line on a live file is expected
                if isinstance(doc, dict):
                    out.append(doc)
    except OSError:
        return out
    return out[-limit:] if limit else out


def _count_lines(path: str) -> int:
    try:
        with open(path, "rb") as f:
            return sum(1 for _ in f)
    except OSError:
        return 0


def collect(obs_dir: str) -> Dict[str, Any]:
    """Gather everything the obs dir has; absent artifacts are None/empty."""
    traces = {}
    for path in sorted(glob.glob(os.path.join(obs_dir, "trace_serve_*.jsonl"))):
        spans = sum(
            1 for doc in load_jsonl(path) if doc.get("ph") == "X"
        )
        traces[os.path.basename(path)] = spans
    flights = sorted(
        os.path.basename(p)
        for p in glob.glob(os.path.join(obs_dir, "flight_slo_burn_*.json"))
    )
    return {
        "obs_dir": os.path.abspath(obs_dir),
        "live": load_json(os.path.join(obs_dir, "serve_live.json")),
        "alerts": load_jsonl(os.path.join(obs_dir, "alerts.jsonl")),
        "access_lines": _count_lines(os.path.join(obs_dir, "access.jsonl")),
        "access_tail": load_jsonl(os.path.join(obs_dir, "access.jsonl"), limit=5),
        "traces": traces,
        "flights": flights,
    }


# ---------------------------------------------------------------------------
# report assembly
# ---------------------------------------------------------------------------


def build_report(art: Dict[str, Any]) -> Dict[str, Any]:
    live = art["live"] or {}
    slo = live.get("slo") if isinstance(live.get("slo"), dict) else {}
    objectives = slo.get("objectives") if isinstance(slo.get("objectives"), dict) else {}
    verdicts = {name: obj.get("verdict") for name, obj in objectives.items()}
    failed = sorted(name for name, v in verdicts.items() if v == "FAIL")
    fired = [a for a in art["alerts"] if a.get("event") == "fire"]
    stages = {
        name.replace("serve/", "", 1): pct
        for name, pct in (live.get("phase_percentiles") or {}).items()
        if isinstance(pct, dict)
    }
    return {
        "obs_dir": art["obs_dir"],
        "generated_at": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "has_snapshot": art["live"] is not None,
        "verdict": "FAIL" if failed else ("PASS" if objectives else "NOT EVALUATED"),
        "failed_objectives": failed,
        "objectives": objectives,
        "alerts": {
            "total_transitions": len(art["alerts"]),
            "fired": len(fired),
            "by_objective": _alert_counts(fired),
            "last": art["alerts"][-10:],
        },
        "requests": {
            "requests": live.get("requests"),
            "failed_requests": live.get("failed_requests"),
            "cancelled_tickets": slo.get("cancelled_tickets"),
            "deadline_misses": live.get("deadline_misses"),
            "batches": live.get("batches"),
            "mean_batch_occupancy": live.get("mean_batch_occupancy"),
            "occupancy_p99": live.get("batch_occupancy_p99"),
        },
        "stages": stages,
        "versions": live.get("serve_versions") or {},
        "sampling": {
            "trace_sampled_requests": live.get("trace_sampled_requests"),
            "trace_files": art["traces"],
            "access_log_lines": art["access_lines"],
            "access_tail": art["access_tail"],
        },
        "flights": art["flights"],
    }


def _alert_counts(fired: List[Dict[str, Any]]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for a in fired:
        key = f"{a.get('objective')}/{a.get('alert')}"
        out[key] = out.get(key, 0) + 1
    return out


# ---------------------------------------------------------------------------
# markdown rendering
# ---------------------------------------------------------------------------


def _fmt(v: Any) -> str:
    if v is None:
        return "—"
    if isinstance(v, bool):
        return "yes" if v else "no"
    if isinstance(v, float):
        return "0" if v == 0 else f"{v:.4g}"
    return str(v)


def _table(rows: List[List[Any]], header: List[str]) -> List[str]:
    out = ["| " + " | ".join(header) + " |", "|" + "---|" * len(header)]
    for row in rows:
        out.append("| " + " | ".join(_fmt(c) for c in row) + " |")
    return out


def render_markdown(rep: Dict[str, Any]) -> str:
    lines: List[str] = []
    lines.append("# Serve report")
    lines.append("")
    lines.append(f"- obs dir: `{rep['obs_dir']}`")
    lines.append(f"- generated: {rep['generated_at']}")
    if not rep["has_snapshot"]:
        lines.append("")
        lines.append(
            "> **No `serve_live.json` found** — the gateway never wrote its "
            "final snapshot (ops surface off, or the process died before "
            "drain). Sections below cover whatever artifacts exist."
        )
    lines.append("")

    lines.append("## SLO verdict")
    lines.append("")
    lines.append(f"**Overall: {rep['verdict']}**")
    if rep["failed_objectives"]:
        lines.append("")
        lines.append(
            "Violated objectives: " + ", ".join(f"`{n}`" for n in rep["failed_objectives"])
        )
    lines.append("")
    objectives = rep["objectives"]
    if objectives:
        lines += _table(
            [
                [
                    name,
                    obj.get("verdict"),
                    obj.get("target"),
                    obj.get("good"),
                    obj.get("bad"),
                    obj.get("burn_fast"),
                    obj.get("burn_slow"),
                    obj.get("fired"),
                ]
                for name, obj in sorted(objectives.items())
            ],
            ["objective", "verdict", "target", "good", "bad",
             "burn (fast)", "burn (slow)", "alerts fired"],
        )
    else:
        lines.append("SLO engine not enabled (`serve.slo.enabled: false`)")
    lines.append("")

    lines.append("## Alerts")
    lines.append("")
    al = rep["alerts"]
    if al["total_transitions"]:
        lines.append(
            f"{al['fired']} firing(s) over {al['total_transitions']} "
            f"transition(s) in `alerts.jsonl`"
        )
        by = al["by_objective"]
        if by:
            lines.append("")
            lines += _table(
                [[k, n] for k, n in sorted(by.items())],
                ["objective/alert", "firings"],
            )
        last = al["last"]
        if last:
            lines.append("")
            lines += _table(
                [
                    [
                        a.get("event"),
                        a.get("objective"),
                        a.get("alert"),
                        a.get("burn_rate"),
                        a.get("threshold"),
                    ]
                    for a in last
                ],
                ["event", "objective", "alert", "burn rate", "threshold"],
            )
    else:
        lines.append("no alert transitions recorded")
    if rep["flights"]:
        lines.append("")
        lines.append(
            "Flight-recorder SLO dumps: " + ", ".join(f"`{f}`" for f in rep["flights"])
        )
    lines.append("")

    lines.append("## Requests")
    lines.append("")
    req = rep["requests"]
    lines += _table(
        [
            ["requests", req.get("requests")],
            ["failed", req.get("failed_requests")],
            ["cancelled tickets", req.get("cancelled_tickets")],
            ["deadline misses", req.get("deadline_misses")],
            ["batches", req.get("batches")],
            ["mean batch occupancy", req.get("mean_batch_occupancy")],
            ["occupancy p99", req.get("occupancy_p99")],
        ],
        ["field", "value"],
    )
    lines.append("")

    lines.append("## Stage latency (ms)")
    lines.append("")
    stages = rep["stages"]
    if stages:
        lines += _table(
            [
                [name, pct.get("p50_ms"), pct.get("p95_ms"), pct.get("p99_ms"),
                 pct.get("count")]
                for name, pct in stages.items()
            ],
            ["stage", "p50", "p95", "p99", "count"],
        )
    else:
        lines.append("not recorded")
    lines.append("")

    lines.append("## Versions served")
    lines.append("")
    versions = rep["versions"]
    if versions:
        lines += _table(
            [
                [v, d.get("requests"), d.get("p50_ms"), d.get("p99_ms")]
                for v, d in sorted(versions.items(), key=lambda kv: int(kv[0]))
                if isinstance(d, dict)
            ],
            ["version", "requests", "p50 (ms)", "p99 (ms)"],
        )
    else:
        lines.append("not recorded")
    lines.append("")

    lines.append("## Sampling")
    lines.append("")
    smp = rep["sampling"]
    lines += _table(
        [
            ["traced requests", smp.get("trace_sampled_requests")],
            ["access-log lines", smp.get("access_log_lines")],
        ]
        + [[f"trace file `{name}`", f"{n} span(s)"] for name, n in smp["trace_files"].items()],
        ["field", "value"],
    )
    lines.append("")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("obs_dir", help="gateway obs dir (serve.obs_dir)")
    ap.add_argument(
        "--out", default=None, help="report path (default <obs_dir>/serve_report.md)"
    )
    ap.add_argument(
        "--json",
        action="store_true",
        help="also write the machine-readable serve_report.json",
    )
    args = ap.parse_args(argv)

    if not os.path.isdir(args.obs_dir):
        print(f"serve_report: not a directory: {args.obs_dir}", file=sys.stderr)
        return 2
    rep = build_report(collect(args.obs_dir))

    out = args.out or os.path.join(args.obs_dir, "serve_report.md")
    text = render_markdown(rep)
    with open(out, "w") as f:
        f.write(text + "\n")
    print(f"serve_report: wrote {out} (verdict: {rep['verdict']})")
    if args.json:
        json_path = os.path.splitext(out)[0] + ".json"
        with open(json_path, "w") as f:
            json.dump(rep, f, indent=2, sort_keys=True)
        print(f"serve_report: wrote {json_path}")
    # CI-gate semantics: a violated objective is a red exit
    return 1 if rep["verdict"] == "FAIL" else 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""Merge trace JSONL files into one Perfetto-loadable trace.json
(counterpart of the JAX package's ``tools/trace_view.py``).

A run's tracer writes one Chrome trace-event object a line into
``<log_dir>/telemetry/trace.jsonl``, and every other process writes its own
file beside it: a process player's ``trace_rank0_player<k>.jsonl``, an env
worker's ``trace_envworker<i>*.jsonl``. A gateway with tracing on writes
``trace_serve_client.jsonl`` and ``trace_serve_gateway.jsonl`` into its obs
dir (the client and gateway lanes of the sampled requests).

Each file's ``ts`` values are microseconds from *its* tracer's origin, so the
files cannot simply be concatenated: this tool aligns them on the
``clock_sync`` wall-clock anchor every tracer writes at open, shifts each
onto the earliest tracer's timeline and wraps everything in the JSON object
Perfetto and ``chrome://tracing`` read. The ``process_name`` metadata of
each tracer labels its track. It imports nothing but the standard library.

Usage::

    python -m sheeprl_tpu_torch.tools.trace_view <run dir | telemetry dir | obs dir | trace.jsonl ...> [-o trace.json]

A directory expands to every ``trace*.jsonl`` in it (or in its
``telemetry/``); files are taken as they are.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple


def discover(paths: List[str]) -> List[str]:
    """Expand run dirs / telemetry dirs to their trace JSONL files."""
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            candidates = sorted(glob.glob(os.path.join(p, "trace*.jsonl")))
            if not candidates:
                candidates = sorted(
                    glob.glob(os.path.join(p, "telemetry", "trace*.jsonl"))
                )
            if not candidates:
                raise FileNotFoundError(f"no trace*.jsonl under {p}")
            out.extend(candidates)
        else:
            out.append(p)
    # de-dup, keep order
    seen = set()
    return [p for p in out if not (p in seen or seen.add(p))]


def load_events(path: str) -> Tuple[List[Dict[str, Any]], Optional[float]]:
    """(events, unix anchor of the tracer's µs origin or None)."""
    events: List[Dict[str, Any]] = []
    anchor: Optional[float] = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                event = json.loads(line)
            except json.JSONDecodeError:
                continue  # a torn tail line from a killed run
            if event.get("ph") == "M" and event.get("name") == "clock_sync":
                ts = (event.get("args") or {}).get("unix_ts")
                if anchor is None and ts is not None:
                    anchor = float(ts)
                continue  # alignment metadata, not a display event
            events.append(event)
    return events, anchor


def merge(files: List[str]) -> Dict[str, Any]:
    """Clock-aligned merge of trace files onto the earliest tracer's origin."""
    loaded = [(path, *load_events(path)) for path in files]
    anchors = [a for _, _, a in loaded if a is not None]
    base = min(anchors) if anchors else 0.0
    merged: List[Dict[str, Any]] = []
    per_file = []
    for path, events, anchor in loaded:
        shift_us = ((anchor - base) * 1e6) if anchor is not None else 0.0
        for event in events:
            if "ts" in event:
                event["ts"] = round(event["ts"] + shift_us, 1)
            merged.append(event)
        per_file.append((path, len(events), shift_us))
    merged.sort(key=lambda e: e.get("ts", 0.0))
    return {"traceEvents": merged, "per_file": per_file}


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("paths", nargs="+", help="run dir, telemetry dir, or trace JSONL files")
    parser.add_argument("-o", "--out", default="trace.json", help="merged output (default trace.json)")
    args = parser.parse_args(argv)

    files = discover(args.paths)
    result = merge(files)
    with open(args.out, "w") as f:
        json.dump({"traceEvents": result["traceEvents"]}, f)
    for path, n, shift_us in result["per_file"]:
        print(f"  {path}: {n} events, shifted +{shift_us / 1e3:.1f} ms")
    print(
        f"{len(result['traceEvents'])} events from {len(files)} file(s) -> "
        f"{args.out} (load in https://ui.perfetto.dev or chrome://tracing)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

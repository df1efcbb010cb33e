"""Cross-process telemetry aggregation: one merged view, per-source truth
(counterpart of ``sheeprl_tpu/obs/dist/aggregate.py``).

Sources and how they reach rank 0 / the learner (the port runs one rank):

==================  =========================================================
source              transport
==================  =========================================================
``rank<k>``         ranks > 0 write a full summary
                    sidecar (``telemetry/sidecar_rank<k>.json``) at finalize;
                    rank 0 SUMS their counters into the merged totals (nothing
                    else ever folds them).
``player<k>``       plane player processes push cumulative counter snapshots
                    over the supervisor's event queue while running (the
                    supervisor folds *deltas* of the shared counter subset and
                    publishes the raw snapshot here), and write a final
                    sidecar (``telemetry/sidecar_player<k>.json``) at exit —
                    breakdown only, their shared counters are already folded.
``envpool*``        env-worker pools publish per-worker step/busy/restart
                    stats at close — in the learner process straight into
                    this registry (+ a sidecar), inside a player process into
                    the player's local registry, embedded in its sidecar and
                    lifted to ``player<k>/envpool*`` here.
==================  =========================================================

``Telemetry.summary()`` attaches the live registry as ``sources`` (so
``live.json`` shows the breakdown mid-run) and ``Telemetry.finalize`` calls
:func:`merge_into_summary` for the durable merge: sidecars win over
in-memory snapshots (they are final), rank counters are summed exactly once,
and a torn/unreadable sidecar degrades to a ``{"torn": true}`` entry instead
of breaking finalize. The merge is deterministic: sources sort by name,
summing is plain integer addition.
"""

from __future__ import annotations

import glob
import json
import os
import re
import threading
from typing import Any, Dict, Optional

__all__ = [
    "atomic_write_json",
    "clear_sources",
    "merge_into_summary",
    "publish_source",
    "read_sidecars",
    "sidecar_path",
    "source_snapshots",
    "write_sidecar",
]

_LOCK = threading.Lock()
_SOURCES: Dict[str, Dict[str, Any]] = {}

_SIDECAR_RE = re.compile(r"sidecar_([A-Za-z0-9_.\-]+)\.json$")

#: counter fields summed across rank sidecars into the merged totals (the
#: plain summable subset of Counters.as_dict — gauges and rates excluded)
SUMMED_RANK_COUNTERS = (
    "bytes_staged_h2d",
    "h2d_transfers",
    "recompiles",
    "compile_cache_hits",
    "nonfinite_metrics",
    "stalls",
    "ckpt_bytes",
    "ckpt_saves",
    "ckpt_failures",
    "ring_gathers",
    "prefetch_hits",
    "prefetch_misses",
    "env_steps_async",
    "env_worker_restarts",
    "env_degraded_to_sync",
    "rollout_bursts",
    "act_dispatches",
    "env_steps_jax",
    "plane_traj_slabs",
    "plane_player_restarts",
    "comms_ops",
    "comms_bytes",
    "comms_ms",
    "flight_dumps",
    "eval_rounds",
    "eval_episodes",
    "inrun_eval_publishes",
)


# -- live registry ------------------------------------------------------------


def publish_source(name: str, snapshot: Dict[str, Any]) -> None:
    """Publish (or refresh) one source's latest cumulative snapshot."""
    if not isinstance(snapshot, dict):
        return
    with _LOCK:
        _SOURCES[str(name)] = dict(snapshot)


def source_snapshots() -> Dict[str, Dict[str, Any]]:
    """The registry's current view, name-sorted (deterministic output)."""
    with _LOCK:
        return {name: dict(_SOURCES[name]) for name in sorted(_SOURCES)}


def clear_sources() -> None:
    with _LOCK:
        _SOURCES.clear()


# -- sidecars -----------------------------------------------------------------


def atomic_write_json(path: str, payload: Dict[str, Any]) -> None:
    """Write ``payload`` through a same-directory tmp file and ``os.replace``,
    so a concurrent reader never sees a torn file."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def sidecar_path(tel_dir: str, name: str) -> str:
    return os.path.join(tel_dir, f"sidecar_{name}.json")


def write_sidecar(tel_dir: str, name: str, payload: Dict[str, Any]) -> Optional[str]:
    """Atomically write one source sidecar; best-effort (a full disk or a
    torn run dir must never take the producing process down)."""
    path = sidecar_path(tel_dir, name)
    try:
        atomic_write_json(path, payload)
    except OSError:
        return None
    return path


def read_sidecars(tel_dir: str) -> Dict[str, Dict[str, Any]]:
    """All readable sidecars under a telemetry dir, name-keyed and sorted.

    A torn/unparseable file (the producer was SIGKILLed mid-write of a
    non-atomic copy, a foreign json landed in the dir) yields
    ``{"torn": True}`` so the merged view records that the source existed
    without poisoning the totals."""
    out: Dict[str, Dict[str, Any]] = {}
    for path in sorted(glob.glob(os.path.join(tel_dir, "sidecar_*.json"))):
        m = _SIDECAR_RE.search(os.path.basename(path))
        if not m:
            continue
        try:
            with open(path) as f:
                doc = json.load(f)
            if not isinstance(doc, dict):
                raise ValueError("sidecar is not an object")
        except Exception:
            out[m.group(1)] = {"torn": True}
            continue
        out[m.group(1)] = doc
    return out


# -- the merge ----------------------------------------------------------------


def _lift_env_pools(sources: Dict[str, Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    """Flatten env pools embedded in player sidecars to first-class
    ``player<k>/envpool*`` sources (players run their pools in-process; the
    learner only ever sees them through the player's sidecar)."""
    lifted: Dict[str, Dict[str, Any]] = {}
    for name, snap in sources.items():
        pools = snap.get("env_pools")
        if isinstance(pools, dict):
            for pool_name in sorted(pools):
                if isinstance(pools[pool_name], dict):
                    lifted[f"{name}/{pool_name}"] = dict(pools[pool_name])
    return lifted


def merge_into_summary(
    summary: Dict[str, Any],
    tel_dir: Optional[str],
    staleness_tracker: Any = None,
) -> Dict[str, Any]:
    """Fold every known source into the final run summary, in place.

    - ``sources``: sidecars (final truth) layered over the live registry,
      env pools lifted out of player sidecars, name-sorted.
    - rank sidecar counters are SUMMED into the summary's counter totals
      (they are folded nowhere else); player/env-pool counters are already
      folded live by the supervisor/pool and stay breakdown-only.
    - rank sidecar ``staleness_dump``s merge exactly into the run tracker
      (same log-bucket merge as the phase histograms) — the caller
      re-reads the tracker's summary afterwards.
    """
    sources: Dict[str, Dict[str, Any]] = dict(source_snapshots())
    if tel_dir:
        sources.update(read_sidecars(tel_dir))
    sources.update(_lift_env_pools(sources))
    if not sources:
        return summary

    for name in sorted(sources):
        snap = sources[name]
        if not name.startswith("rank") or snap.get("torn"):
            continue
        for field in SUMMED_RANK_COUNTERS:
            v = snap.get(field)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                base = summary.get(field)
                if isinstance(base, (int, float)) and not isinstance(base, bool):
                    summary[field] = type(base)(base + v) if isinstance(base, int) else base + v
        if staleness_tracker is not None and isinstance(snap.get("staleness_dump"), dict):
            try:
                staleness_tracker.merge_dict(snap["staleness_dump"])
            except Exception:
                pass  # a foreign/old-schema dump must not break finalize

    # breakdown entries: keep each source's own view, drop the bulky exact
    # histogram dumps (the merged percentiles already absorbed them)
    summary["sources"] = {
        name: {k: v for k, v in sources[name].items() if k != "staleness_dump"}
        for name in sorted(sources)
    }
    return summary

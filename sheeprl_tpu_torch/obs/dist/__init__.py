"""Cross-process observability: the merge of every source process's
telemetry into the run's (``aggregate``) and data-staleness lineage
(``staleness``). The counterpart of ``sheeprl_tpu/obs/dist/`` without its
measured collectives (``comms``), which wait for the port's multi-card
training (ROADMAP queue A item 7). Submodules load on first use."""

import importlib

__all__ = [
    "StalenessTracker",
    "merge_into_summary",
    "publish_source",
    "read_sidecars",
    "source_snapshots",
    "write_sidecar",
]

_EXPORTS = {
    "StalenessTracker": "staleness",
    "merge_into_summary": "aggregate",
    "publish_source": "aggregate",
    "read_sidecars": "aggregate",
    "source_snapshots": "aggregate",
    "write_sidecar": "aggregate",
}


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)

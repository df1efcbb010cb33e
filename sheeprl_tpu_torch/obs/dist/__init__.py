"""Cross-process observability: measured collectives (``comms``), the merge
of every source process's telemetry into the run's (``aggregate``) and
data-staleness lineage (``staleness``); the counterpart of
``sheeprl_tpu/obs/dist/``. ``comms`` is also the one place the port spells
a collective: the gradient sync of every data-parallel step goes through
its ``pmean_``. Submodules load on first use."""

import importlib

__all__ = [
    "StalenessTracker",
    "collective_span",
    "instrumented_all_gather",
    "merge_into_summary",
    "pmean",
    "pmean_",
    "psum",
    "publish_source",
    "read_sidecars",
    "source_snapshots",
    "wire_bytes",
    "write_sidecar",
]

_EXPORTS = {
    "StalenessTracker": ("staleness", "StalenessTracker"),
    "collective_span": ("comms", "collective_span"),
    "instrumented_all_gather": ("comms", "all_gather"),
    "merge_into_summary": ("aggregate", "merge_into_summary"),
    "pmean": ("comms", "pmean"),
    "pmean_": ("comms", "pmean_"),
    "psum": ("comms", "psum"),
    "publish_source": ("aggregate", "publish_source"),
    "read_sidecars": ("aggregate", "read_sidecars"),
    "source_snapshots": ("aggregate", "source_snapshots"),
    "wire_bytes": ("comms", "wire_bytes"),
    "write_sidecar": ("aggregate", "write_sidecar"),
}


def __getattr__(name):
    target = _EXPORTS.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module, attr = target
    return getattr(importlib.import_module(f"{__name__}.{module}"), attr)

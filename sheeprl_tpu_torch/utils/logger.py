"""The run directory (counterpart of ``get_log_dir`` in
``sheeprl_tpu/utils/logger.py``). TensorBoard logging is not ported
(ROADMAP queue A item 6)."""

from __future__ import annotations

import os

__all__ = ["get_log_dir"]


def _next_version(parent: str) -> int:
    if not os.path.isdir(parent):
        return 0
    versions = [
        int(d.split("_")[1]) for d in os.listdir(parent) if d.startswith("version_") and d.split("_")[1].isdigit()
    ]
    return max(versions) + 1 if versions else 0


def get_log_dir(cfg) -> str:
    """Create and return ``logs/runs/<root_dir>/<run_name>/version_<k>``
    (an absolute ``root_dir`` places the run there), ``k`` one past the
    newest existing version."""
    root_dir = cfg.root_dir if cfg.root_dir is not None else "default"
    base = os.path.join("logs", "runs", str(root_dir), str(cfg.run_name))
    log_dir = os.path.join(base, f"version_{_next_version(base)}")
    os.makedirs(log_dir, exist_ok=True)
    return log_dir

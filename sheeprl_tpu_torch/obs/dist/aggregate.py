"""Sidecar files: one JSON document per out-of-process telemetry source
(counterpart of ``sidecar_path`` and ``write_sidecar`` in
``sheeprl_tpu/obs/dist/aggregate.py``). Merging them into the run's
``telemetry.json`` is ROADMAP queue A item 6h."""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

__all__ = ["atomic_write_json", "sidecar_path", "write_sidecar"]


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
    """Atomically write one source's sidecar; a full disk or a vanished run
    dir returns None instead of taking the producing process down."""
    path = sidecar_path(tel_dir, name)
    try:
        atomic_write_json(path, payload)
    except OSError:
        return None
    return path

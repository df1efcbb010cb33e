"""Filesystem model registry: publish trained agents out of run checkpoints
(counterpart of ``sheeprl_tpu/utils/model_manager.py``, same directory
layout and metadata, so either package lists and loads what the other
registered).

``<registry>/<name>/v<k>/`` holds a verbatim copy of the checkpoint
directory (``checkpoint/``), the run's ``config.yaml`` where it was found
beside the checkpoint's run, and ``meta.json``. Versions count up from 1;
a version moves between the ``none``/``staging``/``production`` stages.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Dict, List, Optional

__all__ = ["ModelManager"]

_STAGES = ("none", "staging", "production")


class ModelManager:
    def __init__(self, registry_dir: str = "models"):
        self.registry_dir = os.path.abspath(registry_dir)
        os.makedirs(self.registry_dir, exist_ok=True)

    def _model_dir(self, name: str) -> str:
        return os.path.join(self.registry_dir, name)

    def _versions(self, name: str) -> List[int]:
        mdir = self._model_dir(name)
        if not os.path.isdir(mdir):
            return []
        return sorted(int(d[1:]) for d in os.listdir(mdir) if d.startswith("v") and d[1:].isdigit())

    def _version_dir(self, name: str, version: int) -> str:
        return os.path.join(self._model_dir(name), f"v{version}")

    def _resolve(self, name: str, version: Optional[int]) -> int:
        versions = self._versions(name)
        if not versions:
            raise KeyError(f"No registered model named '{name}' in {self.registry_dir}")
        if version is None:
            return versions[-1]
        if version not in versions:
            raise KeyError(f"Model '{name}' has no version {version}; available: {versions}")
        return version

    def register_model(
        self, name: str, checkpoint_path: str, description: str = "", metadata: Optional[Dict[str, Any]] = None
    ) -> int:
        """Copy the checkpoint directory in as the next version of ``name``
        (with the run's ``.hydra/config.yaml`` where present); returns the
        version."""
        checkpoint_path = os.path.abspath(checkpoint_path)
        if not os.path.isdir(checkpoint_path):
            raise FileNotFoundError(f"Checkpoint not found: {checkpoint_path}")
        versions = self._versions(name)
        version = versions[-1] + 1 if versions else 1
        vdir = self._version_dir(name, version)
        os.makedirs(vdir)
        shutil.copytree(checkpoint_path, os.path.join(vdir, "checkpoint"))
        run_cfg = os.path.join(os.path.dirname(os.path.dirname(checkpoint_path)), ".hydra", "config.yaml")
        if os.path.isfile(run_cfg):
            shutil.copy(run_cfg, os.path.join(vdir, "config.yaml"))
        meta = {
            "name": name,
            "version": version,
            "description": description,
            "source_checkpoint": checkpoint_path,
            "registered_at": time.strftime("%Y-%m-%d %H:%M:%S"),
            "stage": "none",
            **(metadata or {}),
        }
        with open(os.path.join(vdir, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2)
        return version

    def get_model(self, name: str, version: Optional[int] = None) -> str:
        """Path of the registered checkpoint (the latest version by default)."""
        version = self._resolve(name, version)
        return os.path.join(self._version_dir(name, version), "checkpoint")

    def load_model(self, name: str, version: Optional[int] = None) -> Any:
        """The registered checkpoint's state, every array checksummed against
        its manifest (numpy leaves)."""
        from sheeprl_tpu_torch.ckpt.resume import read_checkpoint

        return read_checkpoint(self.get_model(name, version))

    def get_metadata(self, name: str, version: Optional[int] = None) -> Dict[str, Any]:
        version = self._resolve(name, version)
        with open(os.path.join(self._version_dir(name, version), "meta.json")) as f:
            return json.load(f)

    def list_models(self) -> Dict[str, List[Dict[str, Any]]]:
        out: Dict[str, List[Dict[str, Any]]] = {}
        for name in sorted(os.listdir(self.registry_dir)):
            versions = self._versions(name)
            if versions:
                out[name] = [self.get_metadata(name, v) for v in versions]
        return out

    def transition_model(self, name: str, version: Optional[int] = None, stage: str = "staging") -> None:
        """Move a version to another lifecycle stage."""
        if stage not in _STAGES:
            raise ValueError(f"Unknown stage '{stage}'; must be one of {_STAGES}")
        version = self._resolve(name, version)
        path = os.path.join(self._version_dir(name, version), "meta.json")
        with open(path) as f:
            meta = json.load(f)
        meta["stage"] = stage
        with open(path, "w") as f:
            json.dump(meta, f, indent=2)

    def delete_model(self, name: str, version: Optional[int] = None) -> None:
        version = self._resolve(name, version)
        shutil.rmtree(self._version_dir(name, version))
        if not self._versions(name):
            shutil.rmtree(self._model_dir(name), ignore_errors=True)

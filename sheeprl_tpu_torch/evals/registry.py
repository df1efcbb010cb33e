"""The model registry: one append-only ``registry.jsonl`` (counterpart of
``sheeprl_tpu/evals/registry.py``, same file format and schema tag, so a
registry written by either package resolves the same in the other).

One line per evaluation: ``(run, checkpoint, env, algo, config_hash,
metrics)`` and the protocol fields the eval service adds. An append is one
``write → flush → fsync`` of a single line, so a crash can tear only the
last line, which :meth:`ModelRegistry.scan` skips.

An append whose ``config_hash`` differs from the checkpoint manifest's is
refused: a registry row describes the run that made the weights. The hash
recipe is the checkpoint manager's (``ckpt/manager.py``):
``sha256(to_yaml(cfg))[:16]``.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "REGISTRY_SCHEMA",
    "ModelRegistry",
    "RegistryError",
    "manifest_config_hash",
    "registry_config_hash",
    "resolve_checkpoint_ref",
]

#: schema tag stamped on every record: the JAX package's, so both read each other's files
REGISTRY_SCHEMA = "sheeprl_tpu/registry/v1"

#: fields every record must carry to be appendable
REQUIRED_FIELDS = ("run", "checkpoint", "env", "algo", "metrics")


class RegistryError(RuntimeError):
    """A record failed validation (missing fields, config-hash mismatch)."""


def registry_config_hash(cfg) -> Optional[str]:
    """The canonical run-config hash, the checkpoint manager's recipe."""
    from sheeprl_tpu_torch.config.engine import to_yaml

    try:
        return hashlib.sha256(to_yaml(cfg).encode()).hexdigest()[:16]
    except (TypeError, ValueError):
        return None


def manifest_config_hash(checkpoint: str) -> Optional[str]:
    """``config_hash`` of a manifest checkpoint directory, else None."""
    try:
        with open(os.path.join(str(checkpoint), "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError, UnicodeDecodeError):
        return None
    value = manifest.get("config_hash") if isinstance(manifest, dict) else None
    return str(value) if value else None


def resolve_checkpoint_ref(ref: str, registry_dir: str = "logs/registry") -> Tuple[str, Optional[Dict[str, Any]]]:
    """``registry:best:<algo>:<env id>`` → the registry's best record for the
    pair (:meth:`ModelRegistry.best`); anything else is already a path.
    Returns ``(checkpoint_path, record or None)``."""
    ref = str(ref)
    if not ref.startswith("registry:"):
        return ref, None
    parts = ref.split(":")
    if len(parts) != 4 or parts[1] != "best":
        raise ValueError(f"registry checkpoint refs look like registry:best:<algo>:<env id>, got {ref!r}")
    registry = ModelRegistry(str(registry_dir))
    record = registry.best(env=parts[3], algo=parts[2])
    if record is None:
        raise ValueError(f"no registry record for algo={parts[2]!r} env={parts[3]!r} in {registry.path}")
    return str(record["checkpoint"]), record


class ModelRegistry:
    """Append-only JSONL model registry at ``root/registry.jsonl``."""

    def __init__(self, root: str):
        self.root = str(root)
        self.path = os.path.join(self.root, "registry.jsonl")

    def append(self, record: Dict[str, Any], verify: bool = True) -> Dict[str, Any]:
        """Validate and append one record; returns the stamped record.
        ``verify`` checks ``config_hash`` against the checkpoint's manifest
        where both exist (a mismatch raises :class:`RegistryError`) and
        fills it from the manifest where the record has none."""
        rec = dict(record)
        rec.setdefault("schema", REGISTRY_SCHEMA)
        missing = [k for k in REQUIRED_FIELDS if not rec.get(k)]
        if missing:
            raise RegistryError(f"registry record missing fields: {missing}")
        metrics = rec.get("metrics")
        if not isinstance(metrics, dict) or not isinstance(metrics.get("mean"), (int, float)):
            raise RegistryError("registry record needs metrics.mean (a number)")
        if verify:
            manifest_hash = manifest_config_hash(rec["checkpoint"])
            rec_hash = rec.get("config_hash")
            if manifest_hash and rec_hash and str(rec_hash) != manifest_hash:
                raise RegistryError(
                    f"config_hash mismatch for {rec['checkpoint']}: record has {rec_hash}, manifest says "
                    f"{manifest_hash} — refusing to register eval metrics against weights from a different config"
                )
            if manifest_hash and not rec_hash:
                rec["config_hash"] = manifest_hash
        line = json.dumps(rec, sort_keys=True, default=float)
        os.makedirs(self.root, exist_ok=True)
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(line + "\n")
            f.flush()
            os.fsync(f.fileno())
        return rec

    def scan(self) -> List[Dict[str, Any]]:
        """Every parseable record in append order; torn or garbage lines skipped."""
        records: List[Dict[str, Any]] = []
        try:
            with open(self.path, encoding="utf-8", errors="replace") as f:
                for raw in f:
                    raw = raw.strip()
                    if not raw:
                        continue
                    try:
                        rec = json.loads(raw)
                    except json.JSONDecodeError:
                        continue  # a torn tail
                    if isinstance(rec, dict):
                        records.append(rec)
        except FileNotFoundError:
            return []
        return records

    def records(self, env: Optional[str] = None, algo: Optional[str] = None) -> List[Dict[str, Any]]:
        """The scan filtered by env id and/or algo name."""
        return [
            rec
            for rec in self.scan()
            if (env is None or str(rec.get("env")) == str(env)) and (algo is None or str(rec.get("algo")) == str(algo))
        ]

    def best(self, env: str, algo: str) -> Optional[Dict[str, Any]]:
        """The best record for ``(env, algo)``: the highest ``metrics.mean``,
        then the larger episode count ``metrics.n``, then the later append."""
        best_rec: Optional[Dict[str, Any]] = None
        best_key = None
        for idx, rec in enumerate(self.records(env=env, algo=algo)):
            metrics = rec.get("metrics") or {}
            mean = metrics.get("mean")
            if not isinstance(mean, (int, float)):
                continue
            n = metrics.get("n")
            key = (float(mean), int(n) if isinstance(n, (int, float)) else 0, idx)
            if best_key is None or key > best_key:
                best_key, best_rec = key, rec
        return best_rec

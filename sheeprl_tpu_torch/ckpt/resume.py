"""Resume: `latest` resolution, verification, and manifest-format reading
(counterpart of ``sheeprl_tpu/ckpt/resume.py``).

``checkpoint.resume_from=latest`` resolves the newest *manifest-valid*
checkpoint under the run root (``logs/runs/<root_dir>``, spanning every
timestamped run of the experiment), skipping ``.tmp`` partials from killed
writers and directories whose manifest fails to parse or whose shard files
are missing/short. A path to a run dir (or its ``checkpoint/`` dir, or
``<dir>/latest``) resolves within that directory instead. Manifest-less
directories (the JAX package's legacy orbax checkpoints) are not readable
by the port and are never resolved.

:func:`read_checkpoint` is the loader ``Fabric.load`` dispatches to: arrays are checksummed against the manifest before the
state is handed to the algorithms' resume path — a flipped bit fails loudly
here instead of as NaNs a thousand updates later.
"""

from __future__ import annotations

import os
import re
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from sheeprl_tpu_torch.ckpt.manifest import (
    MANIFEST_NAME,
    CheckpointCorruptedError,
    array_crc32,
    decode_array,
    read_manifest,
    unflatten_tree,
)
from sheeprl_tpu_torch.ckpt.writer import TMP_SUFFIX

__all__ = [
    "is_manifest_checkpoint",
    "read_checkpoint",
    "resolve_latest",
    "resolve_resume_from",
    "validate_checkpoint",
]

_CKPT_DIR_RE = re.compile(r"^ckpt_(\d+)(?:_(\d+))?$")


def is_manifest_checkpoint(path: str) -> bool:
    return os.path.isfile(os.path.join(path, MANIFEST_NAME))


def _rank_sibling(path: str, rank: int) -> str:
    """``.../ckpt_<step>_<r>`` → the same step's dir for ``rank``."""
    head, name = os.path.split(os.path.abspath(path))
    m = _CKPT_DIR_RE.match(name)
    if m and m.group(2) is not None:
        return os.path.join(head, f"ckpt_{m.group(1)}_{rank}")
    return os.path.join(head, name)


# -- validation --------------------------------------------------------------


def validate_checkpoint(path: str, deep: bool = False) -> Dict[str, Any]:
    """Validate a manifest checkpoint dir; returns the manifest or raises.

    Quick mode checks the manifest parses and every referenced shard exists
    with its recorded byte size; ``deep`` additionally checksums every array.
    """
    manifest = read_manifest(path)
    for fname, nbytes in (manifest.get("files") or {}).items():
        fpath = os.path.join(path, fname)
        if not os.path.isfile(fpath) or os.path.getsize(fpath) != nbytes:
            raise CheckpointCorruptedError(
                f"checkpoint shard {fname} at {path} is missing or truncated"
            )
    if deep:
        read_checkpoint(path, verify=True)
    return manifest


# -- reading -----------------------------------------------------------------


def _load_npz(path: str) -> Dict[str, np.ndarray]:
    try:
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    except FileNotFoundError:
        raise
    except Exception as exc:
        raise CheckpointCorruptedError(f"unreadable checkpoint shard {path}: {exc}") from exc


def _read_rb(path: str, section: Dict[str, Any], verify: bool) -> Any:
    kind = section.get("kind")
    if kind == "env_sliced":
        per_env: List[Dict[str, np.ndarray]] = []
        for shard in section["shards"]:
            arrays = _load_npz(os.path.join(path, shard["file"]))
            env: Dict[str, np.ndarray] = {}
            for k, meta in shard["arrays"].items():
                stored = arrays[meta["key"]]
                if verify and array_crc32(stored) != meta["crc32"]:
                    raise CheckpointCorruptedError(
                        f"checksum mismatch for buffer key {k!r} in {shard['file']}"
                    )
                env[k] = decode_array(stored, meta)
            per_env.append(env)
        keys = list(per_env[0]) if per_env else []
        return {
            "buffer": {k: np.stack([env[k] for env in per_env], axis=1) for k in keys},
            "pos": int(section.get("pos", 0)),
            "full": bool(section.get("full", False)),
        }
    if kind == "per_buffer":
        subs = []
        for shard in section["shards"]:
            arrays = _load_npz(os.path.join(path, shard["file"]))
            subs.append(
                unflatten_tree(shard["tree"], arrays, verify=verify, where=shard["file"])
            )
        return {section.get("container", "buffers"): subs}
    if kind == "tree":
        arrays = _load_npz(os.path.join(path, section["file"]))
        return unflatten_tree(section["tree"], arrays, verify=verify, where=section["file"])
    raise CheckpointCorruptedError(f"unknown replay-buffer shard kind {kind!r} at {path}")


def read_checkpoint(path: str, rank: int = 0, verify: bool = True, with_rb: bool = True) -> Dict[str, Any]:
    """Load a manifest-format checkpoint into a nested host pytree.

    The model state comes from ``path`` (or, when ``path`` is a non-zero
    rank's buffer-only dir, its rank-0 sibling); replay-buffer shards come
    from the calling rank's own sibling dir when it exists, surfacing under
    the ``"rb"`` key like the embedded legacy layout did; ``with_rb=False``
    leaves them unread (serving needs the model only).
    """
    path = os.path.abspath(path)
    manifest = read_manifest(path)

    state_manifest, state_dir = manifest, path
    if manifest.get("state") is None and manifest.get("rank", 0) != 0:
        sibling = _rank_sibling(path, 0)
        if os.path.isdir(sibling):
            state_manifest, state_dir = read_manifest(sibling), sibling

    out: Dict[str, Any] = {}
    section = state_manifest.get("state")
    if section is not None:
        arrays = _load_npz(os.path.join(state_dir, section["file"]))
        restored = unflatten_tree(
            section["tree"], arrays, verify=verify, where=section["file"]
        )
        if not isinstance(restored, dict):
            raise CheckpointCorruptedError(
                f"checkpoint state at {state_dir} is not a mapping"
            )
        out.update(restored)

    if not with_rb:
        return out
    rb_manifest, rb_dir = manifest, path
    if rank != 0:
        sibling = _rank_sibling(path, rank)
        if sibling != path and os.path.isdir(sibling):
            rb_manifest, rb_dir = read_manifest(sibling), sibling
    if rb_manifest.get("rb") is not None:
        out["rb"] = _read_rb(rb_dir, rb_manifest["rb"], verify)
    return out


# -- `latest` resolution -----------------------------------------------------


def _candidates(root: str) -> List[Tuple[int, int, str]]:
    """(step, rank, path) for every final ckpt dir under ``root``."""
    found: List[Tuple[int, int, str]] = []
    for dirpath, dirnames, _files in os.walk(root):
        for name in list(dirnames):
            if name.endswith(TMP_SUFFIX):
                dirnames.remove(name)  # never descend into partials
                continue
            m = _CKPT_DIR_RE.match(name)
            if m:
                found.append(
                    (int(m.group(1)), int(m.group(2) or 0), os.path.join(dirpath, name))
                )
    return found


def resolve_latest(root: str, rank: int = 0) -> Optional[str]:
    """Newest manifest-valid checkpoint dir under ``root`` (``None`` if none).

    ``.tmp`` partials are never considered; candidates with corrupt or
    incomplete manifests, or with no manifest at all, are skipped with a
    warning.
    """
    ranked = sorted(
        _candidates(root), key=lambda c: (c[0], c[1] == rank, c[2]), reverse=True
    )
    for _step, _r, path in ranked:
        try:
            manifest = validate_checkpoint(path)
            if manifest.get("state") is None:
                # buffer-only shard of a non-zero rank: resumable only if the
                # state-bearing rank-0 sibling of the same step is itself
                # valid (the run may have died between the two renames)
                sibling = _rank_sibling(path, 0)
                if sibling == path or validate_checkpoint(sibling).get("state") is None:
                    raise CheckpointCorruptedError(
                        "checkpoint carries no model state and no state-bearing "
                        "rank-0 sibling exists"
                    )
        except (CheckpointCorruptedError, FileNotFoundError, OSError) as exc:
            warnings.warn(f"skipping invalid checkpoint {path}: {exc}")
            continue
        return path
    return None


def resolve_resume_from(cfg) -> str:
    """Turn ``checkpoint.resume_from`` into a concrete checkpoint dir.

    Accepted forms: ``latest`` (search ``logs/runs/<root_dir>`` — every run
    of this experiment), ``<dir>/latest`` or a run/checkpoint directory
    (search within), or a concrete ``ckpt_*`` path (returned as-is after a
    quick validation of its manifest).
    """
    resume_from = str(cfg.checkpoint.resume_from)
    search_root = None
    if resume_from == "latest":
        search_root = os.path.join("logs", "runs", str(cfg.root_dir))
    elif os.path.basename(resume_from.rstrip("/")) == "latest":
        search_root = os.path.dirname(resume_from.rstrip("/"))
    elif os.path.isdir(resume_from) and not _CKPT_DIR_RE.match(
        os.path.basename(resume_from.rstrip("/"))
    ):
        search_root = resume_from
    if search_root is not None:
        resolved = resolve_latest(search_root)
        if resolved is None:
            raise FileNotFoundError(
                f"checkpoint.resume_from={cfg.checkpoint.resume_from!r}: no "
                f"resumable checkpoint found under {os.path.abspath(search_root)}"
            )
        print(f"[ckpt] resume_from=latest resolved to {resolved}", flush=True)
        return resolved
    validate_checkpoint(resume_from)  # fail at the CLI, not mid-restore
    return resume_from

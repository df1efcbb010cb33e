"""Atomic checkpoint-directory writer (counterpart of ``sheeprl_tpu/ckpt/writer.py``).

Everything lands in ``<final>.tmp/`` first: npz state shard, per-env replay
buffer shards, then ``manifest.json`` last — each file flushed and fsynced —
and the directory is renamed to its final name only after a directory fsync.
``rename(2)`` is atomic on POSIX, so a reader (or a resumed run) either sees
a complete, manifest-valid checkpoint or a ``.tmp`` partial it must skip; a
writer killed at any instruction can never half-produce a final directory.

Replay-buffer states shard per environment instead of one monolithic pickle:

- plain :class:`~sheeprl_tpu_torch.data.buffers.ReplayBuffer`-style states
  (``{"buffer": {k: [size, n_envs, ...]}, "pos", "full"}``) slice along the
  env axis into ``rb_env<i>.npz``;
- :class:`~sheeprl_tpu_torch.data.buffers.EnvIndependentReplayBuffer` states
  (``{"buffers": [...]}``, and the callback's ``{"__list__": [...]}`` wrap)
  write one shard per sub-buffer;
- anything else (EpisodeBuffer's ragged episode lists) falls back to one
  generic treedef shard, still npz.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np

from sheeprl_tpu_torch.ckpt.manifest import (
    SCHEMA_VERSION,
    encode_array,
    flatten_tree,
    write_manifest,
)

__all__ = ["commit_checkpoint", "stage_checkpoint", "write_checkpoint", "TMP_SUFFIX", "OLD_SUFFIX"]

TMP_SUFFIX = ".tmp"
#: a same-step overwrite parks the previous final dir here for the instant
#: between the two renames, so a kill at any point leaves either the old or
#: the new checkpoint fully intact (never a window with neither)
OLD_SUFFIX = ".old"


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_npz(path: str, arrays: Dict[str, np.ndarray], fsync: bool = True) -> int:
    with open(path, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    return os.path.getsize(path)


def _env_sliced_plan(rb_state: Any) -> Optional[int]:
    """n_envs when ``rb_state`` is a ReplayBuffer-style state whose buffer
    arrays all share an env axis (dim 1); None → not env-sliceable."""
    if not isinstance(rb_state, dict) or not isinstance(rb_state.get("buffer"), dict):
        return None
    if set(rb_state) - {"buffer", "pos", "full"}:
        return None
    n_envs = None
    for v in rb_state["buffer"].values():
        arr = np.asarray(v)
        if arr.ndim < 2:
            return None
        if n_envs is None:
            n_envs = arr.shape[1]
        elif arr.shape[1] != n_envs:
            return None
    return n_envs if n_envs else None


def _flatten_rb(
    rb_state: Any, tmp_dir: str, fsync: bool
) -> Tuple[Dict[str, Any], Dict[str, int]]:
    """Write the replay-buffer shards into ``tmp_dir``; returns the manifest
    ``rb`` section and the per-file byte sizes."""
    files: Dict[str, int] = {}

    n_envs = _env_sliced_plan(rb_state)
    if n_envs is not None:
        shards = []
        for i in range(n_envs):
            arrays: Dict[str, np.ndarray] = {}
            leaf_meta: Dict[str, Any] = {}
            for j, (k, v) in enumerate(sorted(rb_state["buffer"].items())):
                stored, meta = encode_array(np.ascontiguousarray(np.asarray(v)[:, i]))
                key = f"b{j}"
                arrays[key] = stored
                meta["key"] = key
                leaf_meta[k] = meta
            fname = f"rb_env{i}.npz"
            files[fname] = _write_npz(os.path.join(tmp_dir, fname), arrays, fsync)
            shards.append({"file": fname, "arrays": leaf_meta})
        return (
            {
                "kind": "env_sliced",
                "n_envs": n_envs,
                "pos": int(np.asarray(rb_state.get("pos", 0))),
                "full": bool(np.asarray(rb_state.get("full", False))),
                "shards": shards,
            },
            files,
        )

    container = None
    if isinstance(rb_state, dict):
        for key in ("buffers", "__list__"):
            if key in rb_state and isinstance(rb_state[key], list) and len(rb_state) == 1:
                container = key
    if container is not None:
        shards = []
        for i, sub in enumerate(rb_state[container]):
            arrays = {}
            treedef = flatten_tree(sub, arrays)
            fname = f"rb_env{i}.npz"
            files[fname] = _write_npz(os.path.join(tmp_dir, fname), arrays, fsync)
            shards.append({"file": fname, "tree": treedef})
        return {"kind": "per_buffer", "container": container, "shards": shards}, files

    arrays = {}
    treedef = flatten_tree(rb_state, arrays)
    files["rb.npz"] = _write_npz(os.path.join(tmp_dir, "rb.npz"), arrays, fsync)
    return {"kind": "tree", "file": "rb.npz", "tree": treedef}, files


def write_checkpoint(
    final_dir: str,
    state: Optional[Dict[str, Any]],
    rb_state: Any = None,
    *,
    step: Optional[int] = None,
    rank: int = 0,
    world_size: int = 1,
    algo: Optional[str] = None,
    config_hash: Optional[str] = None,
    fsync: bool = True,
    sharding: Optional[Dict[str, Any]] = None,
    framework: Optional[str] = None,
) -> int:
    """Write one checkpoint directory atomically; returns bytes written.

    ``state=None`` (non-zero ranks of a replicated model) writes buffer
    shards + manifest only — resume reads the model from the rank-0 sibling.

    ``sharding`` is recorded as given (the JAX package's parameter-sharding
    layout; the port trains on one device and passes None). ``framework``
    names the writer of the state's layout (``"torch"`` for the port); it
    is written only when given, so a JAX-written manifest has no such field.
    """
    nbytes = stage_checkpoint(final_dir, state, rb_state, step=step, rank=rank, world_size=world_size, algo=algo,
                              config_hash=config_hash, fsync=fsync, sharding=sharding, framework=framework)
    commit_checkpoint(final_dir, fsync=fsync)
    return nbytes


def stage_checkpoint(
    final_dir: str,
    state: Optional[Dict[str, Any]],
    rb_state: Any = None,
    *,
    step: Optional[int] = None,
    rank: int = 0,
    world_size: int = 1,
    algo: Optional[str] = None,
    config_hash: Optional[str] = None,
    fsync: bool = True,
    sharding: Optional[Dict[str, Any]] = None,
    framework: Optional[str] = None,
) -> int:
    """The first half of :func:`write_checkpoint`: every file of the
    checkpoint in ``<final_dir>.tmp/``, fsynced, the manifest last; returns
    the bytes written. Nothing is final until :func:`commit_checkpoint`."""
    final_dir = os.path.abspath(final_dir)
    tmp_dir = final_dir + TMP_SUFFIX
    if os.path.isdir(tmp_dir):
        shutil.rmtree(tmp_dir, ignore_errors=True)
    os.makedirs(tmp_dir)

    files: Dict[str, int] = {}
    manifest: Dict[str, Any] = {
        "schema_version": SCHEMA_VERSION,
        "step": step,
        "rank": int(rank),
        "world_size": int(world_size),
        "algo": algo,
        "config_hash": config_hash,
        "state": None,
        "rb": None,
        "sharding": sharding,
    }
    if framework is not None:
        manifest["framework"] = framework

    if state is not None:
        arrays: Dict[str, np.ndarray] = {}
        manifest["state"] = {"file": "state.npz", "tree": flatten_tree(state, arrays)}
        files["state.npz"] = _write_npz(os.path.join(tmp_dir, "state.npz"), arrays, fsync)

    if rb_state is not None:
        manifest["rb"], rb_files = _flatten_rb(rb_state, tmp_dir, fsync)
        files.update(rb_files)

    manifest["files"] = files
    write_manifest(tmp_dir, manifest, fsync=fsync)
    if fsync:
        _fsync_path(tmp_dir)
    return sum(files.values())


def commit_checkpoint(final_dir: str, fsync: bool = True) -> None:
    """The second half of :func:`write_checkpoint`: the staged
    ``<final_dir>.tmp/`` renamed to ``final_dir`` (an existing one parked
    as ``.old`` for the instant between the renames), the parent fsynced."""
    final_dir = os.path.abspath(final_dir)
    tmp_dir = final_dir + TMP_SUFFIX
    old_dir = final_dir + OLD_SUFFIX
    if os.path.isdir(final_dir):
        # same-step overwrite (a resumed run re-writing its save_last step):
        # park the valid old dir aside instead of deleting it, so a kill
        # between here and the rename below cannot lose the only checkpoint
        # for this step — resolve_latest ignores the .old name
        if os.path.isdir(old_dir):
            shutil.rmtree(old_dir, ignore_errors=True)
        os.replace(final_dir, old_dir)
    os.replace(tmp_dir, final_dir)
    if fsync:
        _fsync_path(os.path.dirname(final_dir) or ".")
    shutil.rmtree(old_dir, ignore_errors=True)

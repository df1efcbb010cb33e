"""Checkpoint manifest: the pytree↔npz codec and its integrity metadata
(counterpart of ``sheeprl_tpu/ckpt/manifest.py``: the same on-disk schema,
so the JAX package reads what the port writes and the reverse).

A manifest-format checkpoint directory holds plain ``.npz`` shards plus one
``manifest.json`` describing everything in them:

- ``schema_version`` — layout version; readers refuse versions they do not
  understand instead of half-loading;
- ``step`` / ``rank`` / ``world_size`` / ``algo`` / ``config_hash`` — run
  identity; the port also writes ``framework: "torch"`` (a field the JAX
  reader ignores), so a reader knows the state's layout (the hash is informational: resume already merges the persisted
  config, the manifest just records which one produced the arrays);
- ``files`` — per-file byte sizes (cheap liveness check for ``latest``
  resolution without opening the zips);
- ``state`` / ``rb`` — a JSON *treedef* mirroring the saved pytree, each
  leaf carrying the npz key, shape, dtype and crc32 of the stored bytes.

The treedef makes reconstruction unambiguous (no guessing whether digit
keys meant a list) and doubles as the per-array checksum table. NamedTuples
(optax states) are recorded with their field names and restored as plain
field dicts — ``Fabric.load``'s existing ``conform_pytree`` pass rebuilds
the concrete classes against the caller's live template, exactly as it does
for orbax restores.

npz stores only builtin numpy dtypes faithfully; anything else (bfloat16 &
friends from ml_dtypes) round-trips as a raw byte buffer with the true dtype
name recorded in the leaf — ``np.savez`` would silently degrade them to
void scalars otherwise.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Any, Dict, Tuple

import numpy as np

__all__ = [
    "SCHEMA_VERSION",
    "MANIFEST_NAME",
    "CheckpointCorruptedError",
    "array_crc32",
    "decode_array",
    "encode_array",
    "flatten_tree",
    "read_manifest",
    "unflatten_tree",
    "write_manifest",
]

SCHEMA_VERSION = 1
MANIFEST_NAME = "manifest.json"

#: dtype kinds npz round-trips faithfully (bool/int/uint/float/complex/str/bytes)
_NATIVE_KINDS = "?biufcSU"


class CheckpointCorruptedError(RuntimeError):
    """A checkpoint failed verification (checksum/shape/dtype/layout)."""


# -- array codec ------------------------------------------------------------


def array_crc32(arr: np.ndarray) -> int:
    """crc32 of the array's C-contiguous bytes (the stored representation)."""
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def encode_array(value: Any) -> Tuple[np.ndarray, Dict[str, Any]]:
    """``value`` → (npz-storable array, leaf metadata sans npz key).

    Native-dtype arrays store as-is; exotic dtypes (bfloat16, ...) store as a
    flat uint8 buffer with the true dtype/shape recorded for decode. The
    crc32 always covers the *stored* bytes so verification never has to know
    about dtypes.
    """
    arr = np.asarray(value)
    if arr.dtype.hasobject:
        raise TypeError(
            f"checkpoint state contains a non-array object leaf (dtype={arr.dtype}); "
            "only numeric/bool/string leaves are checkpointable"
        )
    meta: Dict[str, Any] = {"shape": list(arr.shape), "dtype": arr.dtype.name}
    if arr.dtype.kind not in _NATIVE_KINDS:
        arr = np.frombuffer(np.ascontiguousarray(arr).tobytes(), dtype=np.uint8)
        meta["stored_as"] = "raw_bytes"
    meta["crc32"] = array_crc32(arr)
    return arr, meta


def decode_array(stored: np.ndarray, meta: Dict[str, Any]) -> np.ndarray:
    if meta.get("stored_as") == "raw_bytes":
        dtype = np.dtype(meta["dtype"])  # ml_dtypes registers bfloat16 et al.
        return np.frombuffer(stored.tobytes(), dtype=dtype).reshape(meta["shape"])
    return stored


def _verify_leaf(stored: np.ndarray, meta: Dict[str, Any], path: str, where: str) -> None:
    if array_crc32(stored) != meta["crc32"]:
        raise CheckpointCorruptedError(
            f"checksum mismatch for array {path!r} in {where} — the checkpoint "
            "is corrupt (partial write or bit rot); refusing to resume from it"
        )


# -- pytree <-> (treedef, arrays) -------------------------------------------


def flatten_tree(tree: Any, arrays: Dict[str, np.ndarray], prefix: str = "a") -> Dict[str, Any]:
    """Flatten ``tree`` into ``arrays`` (npz key → storable array), returning
    the JSON treedef. Containers: dict / list / tuple / NamedTuple / None."""
    counter = [len(arrays)]

    def rec(node: Any, path: str) -> Dict[str, Any]:
        if node is None:
            return {"__type__": "none"}
        if isinstance(node, dict):
            return {
                "__type__": "dict",
                "items": [[k, rec(v, f"{path}/{k}")] for k, v in node.items()],
            }
        if isinstance(node, tuple) and hasattr(node, "_fields"):  # NamedTuple
            return {
                "__type__": "namedtuple",
                "name": type(node).__name__,
                "items": [
                    [f, rec(v, f"{path}/{f}")] for f, v in zip(node._fields, node)
                ],
            }
        if isinstance(node, (list, tuple)):
            return {
                "__type__": "list" if isinstance(node, list) else "tuple",
                "items": [rec(v, f"{path}/{i}") for i, v in enumerate(node)],
            }
        stored, meta = encode_array(node)
        key = f"{prefix}{counter[0]}"
        counter[0] += 1
        arrays[key] = stored
        leaf = {"__type__": "leaf", "key": key, "path": path}
        leaf.update(meta)
        return leaf

    return rec(tree, "")


def unflatten_tree(
    treedef: Dict[str, Any],
    arrays: Dict[str, np.ndarray],
    verify: bool = True,
    where: str = "checkpoint",
) -> Any:
    """Rebuild the pytree described by ``treedef`` from loaded npz ``arrays``.

    NamedTuples come back as field dicts (``conform_pytree`` rebuilds the
    classes against the live template); tuples come back as tuples. With
    ``verify`` every array is checksummed against the manifest.
    """

    def rec(node: Dict[str, Any]) -> Any:
        kind = node["__type__"]
        if kind == "none":
            return None
        if kind in ("dict", "namedtuple"):
            return {k: rec(v) for k, v in node["items"]}
        if kind in ("list", "tuple"):
            out = [rec(v) for v in node["items"]]
            return tuple(out) if kind == "tuple" else out
        if kind == "leaf":
            try:
                stored = arrays[node["key"]]
            except KeyError:
                raise CheckpointCorruptedError(
                    f"array {node.get('path') or node['key']!r} is missing from "
                    f"{where} — the checkpoint shards are incomplete"
                ) from None
            if verify:
                _verify_leaf(stored, node, node.get("path") or node["key"], where)
            return decode_array(stored, node)
        raise CheckpointCorruptedError(f"unknown treedef node type {kind!r} in {where}")

    return rec(treedef)


# -- manifest I/O -----------------------------------------------------------


def write_manifest(dirname: str, manifest: Dict[str, Any], fsync: bool = True) -> None:
    """Write ``manifest.json`` — the commit record of a checkpoint dir, so it
    is written last and fsynced before the directory is renamed final."""
    path = os.path.join(dirname, MANIFEST_NAME)
    with open(path, "w") as f:
        # one line, through json's C encoder: an indented dump runs its Python encoder, paid at every policy
        # publication (one an update on the actor-learner plane)
        f.write(json.dumps(manifest, sort_keys=True) + "\n")
        f.flush()
        if fsync:
            os.fsync(f.fileno())


def read_manifest(dirname: str) -> Dict[str, Any]:
    path = os.path.join(dirname, MANIFEST_NAME)
    try:
        with open(path) as f:
            manifest = json.load(f)
    except FileNotFoundError:
        raise
    except (json.JSONDecodeError, OSError, UnicodeDecodeError) as exc:
        raise CheckpointCorruptedError(f"unreadable manifest at {path}: {exc}") from exc
    if not isinstance(manifest, dict) or "schema_version" not in manifest:
        raise CheckpointCorruptedError(f"malformed manifest at {path}")
    version = manifest["schema_version"]
    if not isinstance(version, int) or version > SCHEMA_VERSION or version < 1:
        raise CheckpointCorruptedError(
            f"checkpoint at {dirname} has schema_version={version!r}; this build "
            f"reads versions 1..{SCHEMA_VERSION}"
        )
    return manifest

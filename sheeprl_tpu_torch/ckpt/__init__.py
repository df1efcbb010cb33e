"""Checkpoints (counterpart of ``sheeprl_tpu/ckpt``), in the JAX package's
on-disk layout: ``ckpt_<step>_<rank>/`` holding npz shards and a
``manifest.json`` with per-array crc32s, written into ``<dir>.tmp/`` and
renamed at the end; double-buffered background writes; SIGTERM/SIGINT
preemption capture; ``latest`` resolution and verified reads. The JAX
package's ``validate_checkpoint`` and ``read_checkpoint`` accept what the
port writes; the manifest's ``framework`` field (``"torch"``) says the
state holds the port's parameter and optimizer layout.
"""

from sheeprl_tpu_torch.ckpt.manager import (
    FRAMEWORK,
    CheckpointManager,
    get_checkpoint_manager,
    host_snapshot,
    setup_checkpoint,
    should_checkpoint,
    teardown_checkpoint,
    warn_checkpoint_rounding,
)
from sheeprl_tpu_torch.ckpt.manifest import SCHEMA_VERSION, CheckpointCorruptedError, read_manifest
from sheeprl_tpu_torch.ckpt.preemption import preemption_requested
from sheeprl_tpu_torch.ckpt.resume import (
    is_manifest_checkpoint,
    read_checkpoint,
    resolve_latest,
    resolve_resume_from,
    validate_checkpoint,
)

__all__ = [
    "FRAMEWORK",
    "SCHEMA_VERSION",
    "CheckpointCorruptedError",
    "CheckpointManager",
    "get_checkpoint_manager",
    "host_snapshot",
    "is_manifest_checkpoint",
    "preemption_requested",
    "read_checkpoint",
    "read_manifest",
    "resolve_latest",
    "resolve_resume_from",
    "setup_checkpoint",
    "should_checkpoint",
    "teardown_checkpoint",
    "validate_checkpoint",
    "warn_checkpoint_rounding",
]

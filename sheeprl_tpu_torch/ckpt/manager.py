"""The per-run checkpoint manager and the loop-facing helpers (counterpart
of ``sheeprl_tpu/ckpt/manager.py``).

One :class:`CheckpointManager` exists per training run, built by the CLI
from the ``checkpoint`` config group (:func:`setup_checkpoint`, mirroring
the telemetry lifecycle). Algorithms never touch it directly: they dispatch
``fabric.call("on_checkpoint_*")`` exactly as before, and the
:class:`~sheeprl_tpu_torch.utils.callback.CheckpointCallback` routes into
:func:`get_checkpoint_manager`.

Step-path contract of :meth:`CheckpointManager.save`:

1. snapshot the state tree to host: every tensor copied to a numpy array
   the writer owns (the only device interaction, and the only part the
   step must pay for);
2. hand the snapshot to the :class:`~sheeprl_tpu_torch.ckpt.saver.AsyncSaver`
   (waiting out at most one in-flight previous save — double buffering);
3. return. Serialization, fsync, atomic rename, and keep-policy GC all run
   on the writer thread.

The wall time of 1+2 is accounted as :attr:`CheckpointManager.blocked_ms`
— that number IS the checkpoint cost of the train step; the saver's
``stats`` hold the bytes and the write time.

Keep-policy GC (``checkpoint.keep_last``) runs on the writer thread right
after its own rename, so it is serialized with every write and can never
delete a checkpoint that is still being produced; stale ``.tmp`` partials
from a previously killed process are swept on the same pass.

Rank ownership follows the JAX package's: a run on one device is rank 0,
whose ``ckpt_<step>_0`` holds the model state and, when asked, the replay
buffer's shards. In a data-parallel world (one process a device,
``sheeprl_tpu_torch.parallel``) rank 0 writes the replicated model state,
and every rank writes its own replay buffer's shards into its own
``ckpt_<step>_<rank>`` (a buffer is rank state, the model is not); a resume
at the same world size reads the model from rank 0's directory and gives
each rank its own shards back (``ckpt.resume.read_checkpoint``). The
manifest records ``framework: "torch"``.
"""

from __future__ import annotations

import glob
import os
import re
import shutil
import time
import warnings
from typing import Any, Dict, Optional

from sheeprl_tpu_torch.ckpt.preemption import (
    install_preemption_handlers,
    preemption_requested,
    reset_preemption,
    uninstall_preemption_handlers,
)
from sheeprl_tpu_torch.ckpt.saver import AsyncSaver
from sheeprl_tpu_torch.ckpt.writer import OLD_SUFFIX, TMP_SUFFIX, write_checkpoint
from sheeprl_tpu_torch.obs.counters import add_ckpt_blocked_ms

__all__ = [
    "FRAMEWORK",
    "CheckpointManager",
    "get_checkpoint_manager",
    "host_snapshot",
    "setup_checkpoint",
    "should_checkpoint",
    "teardown_checkpoint",
    "warn_checkpoint_rounding",
]

_STEP_RE = re.compile(r"ckpt_(\d+)")
#: the manifest's ``framework`` field: the layout of the state the port writes
FRAMEWORK = "torch"

_ACTIVE: Optional["CheckpointManager"] = None
_FALLBACK: Optional["CheckpointManager"] = None


class CheckpointManager:
    def __init__(
        self,
        async_save: bool = True,
        keep_last: Optional[int] = None,
        retries: int = 3,
        backoff_s: float = 0.5,
        algo: Optional[str] = None,
        config_hash: Optional[str] = None,
    ):
        self.async_save = bool(async_save)
        self.keep_last = keep_last
        self.algo = algo
        self.config_hash = config_hash
        self.blocked_ms = 0.0
        self._saver = AsyncSaver(retries=retries, backoff_s=backoff_s)

    # -- persistence --------------------------------------------------------

    def save(
        self,
        ckpt_path: str,
        state: Optional[Dict[str, Any]],
        rb_state: Any = None,
        fabric: Any = None,
        keep_last: Optional[int] = None,
        sync: Optional[bool] = None,
    ) -> None:
        """Snapshot ``state``/``rb_state`` and persist them as ``ckpt_path``.

        ``state`` is a tree of dicts, lists and tuples whose leaves are
        tensors (any device), numpy arrays or Python scalars. ``keep_last``
        overrides the manager policy (callback-level knob); ``sync`` forces
        a synchronous write (for callers that must see write errors inline).
        """
        t0 = time.perf_counter()
        rank = int(fabric.global_rank) if fabric is not None else 0
        world_size = int(fabric.world_size) if fabric is not None else 1
        host_state = host_snapshot(state) if (state is not None and rank == 0) else None
        m = _STEP_RE.search(os.path.basename(ckpt_path))
        step = int(m.group(1)) if m else None
        keep = self.keep_last if keep_last is None else keep_last
        ckpt_path = os.path.abspath(ckpt_path)

        def _write() -> int:
            nbytes = write_checkpoint(
                ckpt_path,
                host_state,
                rb_state,
                step=step,
                rank=rank,
                world_size=world_size,
                algo=self.algo,
                config_hash=self.config_hash,
                framework=FRAMEWORK,
            )
            self._prune(os.path.dirname(ckpt_path), rank, keep)
            return nbytes

        self._saver.submit(
            _write,
            label=os.path.basename(ckpt_path),
            sync=(not self.async_save) if sync is None else sync,
        )
        blocked_ms = (time.perf_counter() - t0) * 1000.0
        self.blocked_ms += blocked_ms
        add_ckpt_blocked_ms(blocked_ms)

    @property
    def stats(self) -> Dict[str, Any]:
        """Writes, failed writes, bytes and write time so far, and the time
        the step path blocked on saves."""
        return {**self._saver.stats, "blocked_ms": self.blocked_ms}

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Wait for the in-flight async save to land (preemption/teardown)."""
        return self._saver.drain(timeout)

    @property
    def degraded(self) -> bool:
        return self._saver.degraded

    # -- keep-policy GC (runs on the writer thread, post-rename) ------------

    @staticmethod
    def _owned_step(name: str, rank: int) -> Optional[int]:
        """Step number when ``name`` is a ckpt dir THIS rank owns (its own
        ``ckpt_<step>_<rank>``, plus legacy un-suffixed dirs on rank 0)."""
        m = re.fullmatch(r"ckpt_(\d+)_(\d+)", name)
        if m:
            return int(m.group(1)) if int(m.group(2)) == rank else None
        if rank == 0:
            m = re.fullmatch(r"ckpt_(\d+)", name)
            if m:
                return int(m.group(1))
        return None

    def _prune(self, ckpt_dir: str, rank: int, keep_last: Optional[int]) -> None:
        if not os.path.isdir(ckpt_dir):
            return
        # stale partials: any of THIS rank's .tmp/.old dirs belongs to a dead
        # writer — the live one (this thread) already renamed its own. Other
        # ranks' .tmp dirs may be their in-flight writes; never touch them.
        for suffix in (TMP_SUFFIX, OLD_SUFFIX):
            for leftover in glob.glob(os.path.join(ckpt_dir, f"ckpt_*{suffix}")):
                name = os.path.basename(leftover)[: -len(suffix)]
                if self._owned_step(name, rank) is not None:
                    shutil.rmtree(leftover, ignore_errors=True)
        if not keep_last:
            return
        owned = []
        for path in glob.glob(os.path.join(ckpt_dir, "ckpt_*")):
            name = os.path.basename(path)
            if name.endswith(TMP_SUFFIX):
                continue
            step = self._owned_step(name, rank)
            if step is not None:
                owned.append((step, path))
        for _step, path in sorted(owned)[: -int(keep_last)]:
            shutil.rmtree(path, ignore_errors=True)


def host_snapshot(tree: Any) -> Any:
    """A copy of ``tree`` the writer thread owns: tensors copied to numpy
    on the host, numpy arrays copied unless they own their memory, other
    leaves as they are. Dicts, lists and tuples keep their structure."""
    import numpy as np
    import torch

    if isinstance(tree, dict):
        return {k: host_snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_snapshot(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True).numpy()
    if isinstance(tree, np.ndarray) and not tree.flags.owndata:
        return np.array(tree, copy=True)
    return tree


# -- run lifecycle (CLI-owned, telemetry-style) ------------------------------


def get_checkpoint_manager() -> CheckpointManager:
    """The run's manager; outside a CLI run, a process-wide default (async
    on, no keep policy) so direct callback use still gets the full pipeline."""
    global _FALLBACK
    if _ACTIVE is not None:
        return _ACTIVE
    if _FALLBACK is None:
        _FALLBACK = CheckpointManager()
    return _FALLBACK


def setup_checkpoint(cfg) -> CheckpointManager:
    """Build and activate the run manager from a composed config; installs
    the preemption handlers (main thread only)."""
    global _ACTIVE
    ccfg = cfg.get("checkpoint", {}) if hasattr(cfg, "get") else {}
    config_hash = None
    try:
        import hashlib

        from sheeprl_tpu_torch.config.engine import to_yaml

        config_hash = hashlib.sha256(to_yaml(cfg).encode()).hexdigest()[:16]
    except Exception:  # pragma: no cover - hash is informational
        pass
    algo = None
    try:
        algo = str(cfg.algo.name)
    except AttributeError:
        pass
    _ACTIVE = CheckpointManager(
        async_save=bool(ccfg.get("async_save", True)),
        keep_last=ccfg.get("keep_last", None),
        retries=int(ccfg.get("write_retries", 3)),
        backoff_s=float(ccfg.get("write_backoff_s", 0.5)),
        algo=algo,
        config_hash=config_hash,
    )
    # a previous in-process run (multirun job, test) may have been preempted;
    # this run starts fresh — its own handlers are (re)installed below
    reset_preemption()
    install_preemption_handlers()
    return _ACTIVE


def teardown_checkpoint(drain_timeout: Optional[float] = 300.0) -> Optional[Dict[str, Any]]:
    """Drain in-flight saves and deactivate (idempotent; CLI ``finally``).
    Returns the run manager's :attr:`~CheckpointManager.stats` after the
    drain (None when no run manager was active)."""
    global _ACTIVE
    manager, _ACTIVE = _ACTIVE, None
    for m in (manager, _FALLBACK):
        if m is not None and not m.drain(drain_timeout):
            warnings.warn("a checkpoint write was still in flight after the drain timeout")
    uninstall_preemption_handlers()
    return manager.stats if manager is not None else None


# -- loop helpers (the only surface the 17 entrypoints see) ------------------


def should_checkpoint(
    cfg, policy_step: int, last_checkpoint: int, update: int, num_updates: int
) -> bool:
    """The per-update checkpoint gate: the reference cadence
    (``checkpoint.every`` policy steps, plus ``save_last`` on the final
    update) extended with preemption capture — a SIGTERM/SIGINT forces an
    immediate save regardless of cadence."""
    checkpointing_enabled = cfg.checkpoint.every > 0 or cfg.checkpoint.save_last
    return (
        (cfg.checkpoint.every > 0 and policy_step - last_checkpoint >= cfg.checkpoint.every)
        or (update == num_updates and cfg.checkpoint.save_last)
        # preemption forces an immediate save — but not for runs that turned
        # checkpointing off entirely (benchmarks, throwaway probes)
        or (checkpointing_enabled and preemption_requested())
    )


def warn_checkpoint_rounding(cfg, policy_steps_per_update: int) -> None:
    """The (formerly copy-pasted-per-algo) ``checkpoint.every`` rounding
    warning: saves happen at update boundaries, so a non-multiple cadence
    rounds up to the next one."""
    if cfg.checkpoint.every % policy_steps_per_update != 0:
        warnings.warn(
            f"The checkpoint.every parameter ({cfg.checkpoint.every}) is not a multiple of the "
            f"policy_steps_per_update value ({policy_steps_per_update}), so "
            "the checkpoint will be saved at the nearest greater multiple of the "
            "policy_steps_per_update value."
        )

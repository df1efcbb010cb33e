"""Shared-memory trajectory slab rings with credited-slot backpressure
(counterpart of ``sheeprl_tpu/plane/slabs.py``).

One :class:`TrajSlabRing` joins one player process to the learner. Every
array the player would hand to the replay buffer's ``add`` lives in a
fixed-layout shared block ``[n_slots, steps, n_envs, *single_shape]`` (one
``multiprocessing.RawArray`` a key: anonymous, inherited at start), so the
learner reads a committed slab as numpy views and the one copy of the path
is its ``add``.

Backpressure is credited slots: the ``free`` queue starts with every slot
and the player takes one before it writes, so a slow learner throttles the
players at ``plane.queue_slots`` slabs each. The ``filled`` queue carries
only the commit record (slot, first update, rows, policy version, episode
stats, the player's host seconds by phase for the slab): bulk data never
crosses a pipe. The layout is a :class:`SlabSpec` both sides build their views
from.
"""

from __future__ import annotations

import queue as _queue
import time
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

__all__ = ["PlaneClosed", "SlabHandle", "SlabSpec", "TrajSlabRing"]


class PlaneClosed(RuntimeError):
    """The plane (or a publication channel) is stopping: a blocked wait gives up."""


@dataclass(frozen=True)
class SlabSpec:
    """One slab's layout: each key's ``(steps, n_envs, *single_shape)`` and
    dtype (a per-burst extra such as PPO's ``next_values`` has ``steps=1``)."""

    keys: Tuple[Tuple[str, Tuple[int, ...], str], ...]

    @classmethod
    def from_arrays(cls, example: Dict[str, np.ndarray]) -> "SlabSpec":
        return cls(tuple((k, tuple(int(s) for s in v.shape), np.dtype(v.dtype).name) for k, v in example.items()))

    def nbytes(self) -> int:
        return sum(int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize for _, shape, dtype in self.keys)


def _alloc(ctx, shape: Tuple[int, ...], dtype: np.dtype):
    return ctx.RawArray("b", max(int(np.prod(shape, dtype=np.int64)) * dtype.itemsize, 1))


def _view(raw, shape: Tuple[int, ...], dtype: np.dtype) -> np.ndarray:
    return np.frombuffer(raw, dtype=dtype, count=int(np.prod(shape, dtype=np.int64))).reshape(shape)


@dataclass
class SlabHandle:
    """One committed slab on the learner's side: views and the commit
    record. ``release()`` gives the slot back to the player: call it once
    the rows have been copied out."""

    data: Dict[str, np.ndarray]
    first_update: int
    n_valid: int
    policy_version: int
    ep_stats: List[Tuple[float, float]]
    _ring: Optional["TrajSlabRing"]
    _slot: int
    #: the player's host seconds for this slab by phase (its env steps, acting, its waits)
    seconds: Dict[str, float] = field(default_factory=dict)
    #: the commit's wall time (``time.time()``), where the rows' sample age starts
    commit_ts: float = 0.0

    def release(self) -> None:
        if self._ring is not None:
            ring, self._ring = self._ring, None
            ring._free.put(self._slot)


class TrajSlabRing:
    """The per-player slab transport, made in the learner from a
    multiprocessing context and passed whole to the player process.

    Player: ``slot = ring.acquire(stop)``, ``views = ring.writer_views(slot)``,
    fill ``views[k][:n]``, ``ring.commit(slot, first_update, n, version,
    ep_stats)``. Learner: ``handle = ring.recv(timeout)``, copy
    ``handle.data[k][:handle.n_valid]``, ``handle.release()``."""

    def __init__(self, ctx, spec: SlabSpec, n_slots: int):
        if n_slots < 1:
            raise ValueError(f"TrajSlabRing needs >=1 slot, got {n_slots}")
        self.spec = spec
        self.n_slots = int(n_slots)
        self._raw = {key: _alloc(ctx, (self.n_slots, *shape), np.dtype(dtype)) for key, shape, dtype in spec.keys}
        self._free = ctx.Queue()
        self._filled = ctx.Queue()
        for slot in range(self.n_slots):
            self._free.put(slot)
        self._views: Optional[Dict[str, np.ndarray]] = None

    def _all_views(self) -> Dict[str, np.ndarray]:
        if self._views is None:
            self._views = {key: _view(self._raw[key], (self.n_slots, *shape), np.dtype(dtype))
                           for key, shape, dtype in self.spec.keys}
        return self._views

    def writer_views(self, slot: int) -> Dict[str, np.ndarray]:
        return {k: v[slot] for k, v in self._all_views().items()}

    # -- the player's side ----------------------------------------------------

    def acquire(self, stop=None, poll_s: float = 0.2) -> int:
        """Take a slot credit, blocking until the learner returns one;
        raises :class:`PlaneClosed` once ``stop`` is set."""
        while True:
            try:
                return self._free.get(timeout=poll_s)
            except _queue.Empty:
                if stop is not None and stop.is_set():
                    raise PlaneClosed("plane stopping while waiting for a slab credit")

    def commit(self, slot: int, first_update: int, n_valid: int, policy_version: int,
               ep_stats: Optional[List[Tuple[float, float]]] = None,
               seconds: Optional[Mapping[str, float]] = None) -> None:
        self._filled.put((int(slot), int(first_update), int(n_valid), int(policy_version), list(ep_stats or []),
                          dict(seconds or {}), time.time()))

    # -- the learner's side ---------------------------------------------------

    def recv(self, timeout: Optional[float] = None) -> Optional[SlabHandle]:
        """The next committed slab, or None on timeout."""
        try:
            slot, first_update, n_valid, version, ep_stats, seconds, commit_ts = self._filled.get(timeout=timeout)
        except _queue.Empty:
            return None
        return SlabHandle(data=self.writer_views(slot), first_update=first_update, n_valid=n_valid,
                          policy_version=version, ep_stats=ep_stats, _ring=self, _slot=slot, seconds=seconds,
                          commit_ts=commit_ts)

    def depth(self) -> Optional[int]:
        """Committed slabs waiting for the learner (None where the platform cannot count them)."""
        try:
            return int(self._filled.qsize())
        except NotImplementedError:
            return None

    def close(self) -> None:
        """Drop the queues' feeder threads, so that the interpreter's exit never waits on them."""
        for q in (self._free, self._filled):
            try:
                q.cancel_join_thread()
                q.close()
            except Exception:
                pass

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_views"] = None  # views are per process
        return state

"""Shared-memory act-request transport between client processes and the
gateway (counterpart of ``ActSlabRing`` in ``sheeprl_tpu/serve/rings.py``).

Each client owns one slot of a preallocated observation slab and one slot of
an action slab, so a request is

  client: write the obs row into its slot → enqueue ``(slot, seq, reset)``
  server: batch what is queued → write the action rows into the same slots
          → post ``(seq, version, error)`` on that client's response queue

Only the small commit records cross a pickling queue. A client has at most
one request in flight (it owns its slot), so no free list is needed and a
crashed client cannot corrupt another's rows.

The ring is numpy over ``multiprocessing`` shared memory and imports no
torch: it pickles to a ``spawn``-ed child (cached views are dropped in
``__getstate__`` and rebuilt there), so a client never touches the card.
``close()`` sets the shared stop event: a blocked client raises
:class:`RingClosed` instead of hanging. The layout is versioned: a ring
pickled by another layout refuses to unpickle.
"""

from __future__ import annotations

import queue
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["RING_LAYOUT_VERSION", "ActSlabRing", "RingClosed"]

#: bump on any change of the slabs or of the queue records
RING_LAYOUT_VERSION = 1


class RingClosed(RuntimeError):
    """The ring stopped while a client waited for its response."""


def _nbytes(shape: Tuple[int, ...], dtype: np.dtype) -> int:
    return int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize


class ActSlabRing:
    """Preallocated obs and action slabs, one slot a client."""

    def __init__(
        self,
        obs_spec: Dict[str, Tuple[Tuple[int, ...], Any]],
        act_shape: Tuple[int, ...],
        act_dtype: Any,
        n_clients: int,
        ctx=None,
    ):
        if int(n_clients) < 1:
            raise ValueError(f"n_clients must be >= 1, got {n_clients}")
        if ctx is None:
            import multiprocessing as mp

            ctx = mp.get_context("spawn")
        self.n_clients = int(n_clients)
        self.obs_spec = {str(k): (tuple(shape), np.dtype(dtype)) for k, (shape, dtype) in obs_spec.items()}
        self.act_shape = tuple(act_shape)
        self.act_dtype = np.dtype(act_dtype)
        self._obs_blocks = {
            k: ctx.RawArray("b", self.n_clients * _nbytes(shape, dtype)) for k, (shape, dtype) in self.obs_spec.items()
        }
        self._act_block = ctx.RawArray("b", self.n_clients * _nbytes(self.act_shape, self.act_dtype))
        self._layout = RING_LAYOUT_VERSION
        self._requests = ctx.Queue()
        self._responses = [ctx.Queue() for _ in range(self.n_clients)]
        self._stop = ctx.Event()
        self._views: Optional[Dict[str, np.ndarray]] = None
        self._act_view: Optional[np.ndarray] = None

    @classmethod
    def from_example(cls, obs_row: Dict[str, np.ndarray], act_row: np.ndarray, n_clients: int, ctx=None):
        """Size the slabs from one example request and response row."""
        spec = {k: (np.asarray(v).shape, np.asarray(v).dtype) for k, v in obs_row.items()}
        act = np.asarray(act_row)
        return cls(spec, act.shape, act.dtype, n_clients, ctx=ctx)

    def _obs_views(self) -> Dict[str, np.ndarray]:
        if self._views is None:
            self._views = {
                k: np.frombuffer(self._obs_blocks[k], dtype=dtype).reshape((self.n_clients,) + shape)
                for k, (shape, dtype) in self.obs_spec.items()
            }
        return self._views

    def _act_views(self) -> np.ndarray:
        if self._act_view is None:
            self._act_view = np.frombuffer(self._act_block, dtype=self.act_dtype).reshape(
                (self.n_clients,) + self.act_shape
            )
        return self._act_view

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_views"] = None  # numpy views do not cross processes: rebuilt from the RawArrays
        state["_act_view"] = None
        return state

    def __setstate__(self, state):
        got = state.get("_layout")
        if got != RING_LAYOUT_VERSION:
            raise RuntimeError(
                f"ActSlabRing layout mismatch: the pickled ring has layout {got!r}, this build "
                f"{RING_LAYOUT_VERSION}; client and gateway must run the same build"
            )
        self.__dict__.update(state)

    # ------------------------------------------------------------ client side

    def request(self, slot: int, obs_row: Dict[str, np.ndarray], seq: int, reset: bool) -> None:
        """Write the obs row into the client's slot and commit the request."""
        views = self._obs_views()
        for k, (shape, dtype) in self.obs_spec.items():
            views[k][slot] = np.asarray(obs_row[k], dtype=dtype).reshape(shape)
        self._requests.put((int(slot), int(seq), bool(reset)))

    def wait_response(self, slot: int, seq: int, timeout: float = 30.0) -> Tuple[np.ndarray, int]:
        """Block for the client's response; returns ``(action_row, version)``.
        A response of an older ``seq`` (an abandoned request) is dropped."""
        deadline = time.monotonic() + float(timeout)
        q = self._responses[int(slot)]
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(f"serve ring response timed out (slot {slot})")
            try:
                got_seq, version, error = q.get(timeout=min(remaining, 0.1))
            except queue.Empty:
                if self._stop.is_set():
                    raise RingClosed("serve ring closed while waiting for a response") from None
                continue
            if got_seq != int(seq):
                continue
            if error is not None:
                raise RuntimeError(f"serve request failed on the gateway: {error}")
            return self._act_views()[int(slot)].copy(), int(version)

    # ------------------------------------------------------------ server side

    def next_requests(self, timeout: float = 0.05) -> List[Tuple[int, int, bool]]:
        """Block up to ``timeout`` for a first request, then take every one
        already queued (the coalescing window is the batcher's)."""
        out: List[Tuple[int, int, bool]] = []
        try:
            out.append(self._requests.get(timeout=timeout))
        except queue.Empty:
            return out
        while True:
            try:
                out.append(self._requests.get_nowait())
            except queue.Empty:
                return out

    def read_obs_row(self, slot: int) -> Dict[str, np.ndarray]:
        """A copy of one client's observation row."""
        views = self._obs_views()
        return {k: views[k][int(slot)].copy() for k in self.obs_spec}

    def respond(
        self, slot: int, seq: int, action_row: Optional[np.ndarray], version: int, error: Optional[str] = None
    ) -> None:
        if action_row is not None:
            self._act_views()[int(slot)] = np.asarray(action_row, dtype=self.act_dtype).reshape(self.act_shape)
        self._responses[int(slot)].put((int(seq), int(version), error))

    # -------------------------------------------------------------- lifecycle

    def close(self) -> None:
        self._stop.set()
        # queue feeder threads must never block interpreter shutdown on unflushed buffers
        for q in [self._requests, *self._responses]:
            q.cancel_join_thread()

"""Serve clients (counterpart of ``sheeprl_tpu/serve/client.py``): the
in-process :class:`LocalServeClient` and the cross-process
:class:`RingServeClient` over one slot of an
:class:`~sheeprl_tpu_torch.serve.rings.ActSlabRing`.

A client never sees the model: it hands an observation row to the gateway
and gets ``(action_row, version)`` back. ``reset=True`` marks an episode
boundary, where the gateway starts the client's recurrent state afresh.

Tracing: a :class:`LocalServeClient` takes its request's baton from
:func:`~sheeprl_tpu_torch.obs.reqtrace.sample` (the gateway's tracer); a
:class:`RingServeClient`, whose process has no tracer, stamps every
``ring.trace_every``-th request itself and sends the stamps through the
ring's metadata block.
"""

from __future__ import annotations

import itertools
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from sheeprl_tpu_torch.obs import reqtrace
from sheeprl_tpu_torch.obs.reqtrace import RequestTrace
from sheeprl_tpu_torch.obs.reqtrace import now as _now

__all__ = ["LocalServeClient", "RingServeClient"]

_client_counter = itertools.count()
_counter_lock = threading.Lock()


def _auto_id(prefix: str) -> str:
    with _counter_lock:
        return f"{prefix}{next(_client_counter)}"


class LocalServeClient:
    """One logical actor: one recurrent-state key on the server."""

    def __init__(self, batcher, client_id: Optional[str] = None):
        self._batcher = batcher
        self.client_id = str(client_id) if client_id is not None else _auto_id("local")
        self._pending = None
        self._closed = False

    def act(
        self, obs_row: Dict[str, np.ndarray], reset: bool = False, timeout: Optional[float] = 30.0
    ) -> Tuple[np.ndarray, int]:
        """One request → one action row plus the serving model version."""
        if self._closed:
            raise RuntimeError(f"client {self.client_id} is closed")
        trace = reqtrace.sample()  # None, after one global read, when tracing is off
        if trace is not None:
            trace.t_enqueue = _now()
        pending = self._batcher.submit(self.client_id, obs_row, reset=reset, trace=trace)
        self._pending = pending
        try:
            return self._batcher.wait(pending, timeout=timeout)
        except TimeoutError:
            self._batcher.cancel(pending)
            raise
        finally:
            self._pending = None

    def close(self) -> None:
        """Disconnect: cancel anything in flight, drop server-side state."""
        self._closed = True
        pending = self._pending
        if pending is not None:
            self._batcher.cancel(pending)
        self._batcher.forget_client(self.client_id)


class RingServeClient:
    """A client in another process, bound to one slot of an ``ActSlabRing``.
    Made in the parent and sent to a spawned child (the ring pickles), or
    made in the child from the ring it got. One request in flight at most:
    the client owns its slot. It imports no torch."""

    def __init__(self, ring, slot: int):
        self._ring = ring
        self.slot = int(slot)
        self.client_id = f"ring{self.slot}"
        self._seq = 0

    def act(self, obs_row: Dict[str, np.ndarray], reset: bool = False, timeout: float = 30.0) -> Tuple[np.ndarray, int]:
        self._seq += 1
        every = int(getattr(self._ring, "trace_every", 0) or 0)
        trace = None
        if every > 0 and (self._seq - 1) % every == 0:
            # the JAX package's id scheme: unique across slots while a slot sends fewer than a million requests
            trace = RequestTrace((self.slot + 1) * 1_000_000 + self._seq, t_start=_now())
        self._ring.request(self.slot, obs_row, self._seq, reset, trace=trace)
        return self._ring.wait_response(self.slot, self._seq, timeout=timeout)

    def close(self) -> None:
        """Nothing to release: the slot is the client's for the ring's life,
        and an unread response is dropped by the next ``act``'s seq check."""

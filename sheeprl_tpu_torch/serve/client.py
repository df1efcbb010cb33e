"""In-process serve client (counterpart of ``LocalServeClient`` in
``sheeprl_tpu/serve/client.py``; the cross-process ring client is not ported
yet).

A client never sees the model: it hands an observation row to the gateway
and gets ``(action_row, version)`` back. ``reset=True`` marks an episode
boundary, where the gateway starts the client's recurrent state afresh.
"""

from __future__ import annotations

import itertools
import threading
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["LocalServeClient"]

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
        pending = self._batcher.submit(self.client_id, obs_row, reset=reset)
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

"""The thread transport of ``plane.num_players=0`` (counterpart of
``sheeprl_tpu/plane/local.py``): the player is a thread running the same
player loop the process plane starts, committing the same bursts through a
bounded in-memory queue with the slab ring's credit semantics, and loading
policy versions from :class:`~sheeprl_tpu_torch.plane.publish.LocalPolicyChannel`.
"""

from __future__ import annotations

import queue as _queue
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from sheeprl_tpu_torch.plane.slabs import PlaneClosed

__all__ = ["BurstPayload", "LocalBurstQueue", "LocalPlayerHandle"]


@dataclass
class BurstPayload:
    """One committed burst (arrays the player allocated for it, shared by reference)."""

    data: Dict[str, np.ndarray]
    first_update: int
    n_valid: int
    policy_version: int
    ep_stats: List[Tuple[float, float]] = field(default_factory=list)
    seconds: Dict[str, float] = field(default_factory=dict)
    commit_ts: float = 0.0

    def release(self) -> None:  # the slab handle's surface
        pass


class LocalBurstQueue:
    """Bounded queue between the player thread and the learner: ``maxsize``
    plays the slab credits (a slow learner blocks the player's commit)."""

    def __init__(self, n_slots: int):
        self._q: "_queue.Queue[BurstPayload]" = _queue.Queue(maxsize=max(int(n_slots), 1))

    def commit(self, payload: BurstPayload, stop=None, poll_s: float = 0.2) -> None:
        while True:
            try:
                self._q.put(payload, timeout=poll_s)
                return
            except _queue.Full:
                if stop is not None and stop.is_set():
                    raise PlaneClosed("plane stopping while waiting for a burst credit")

    def recv(self, timeout: Optional[float] = None) -> Optional[BurstPayload]:
        try:
            return self._q.get(timeout=timeout)
        except _queue.Empty:
            return None

    def depth(self) -> int:
        """Committed bursts waiting for the learner."""
        return self._q.qsize()

    def drain(self) -> None:
        """Unblock a player stuck on a full queue at shutdown."""
        while True:
            try:
                self._q.get_nowait()
            except _queue.Empty:
                return


class LocalPlayerHandle:
    """The player thread: ``target`` is the player loop; an exception it
    raises is raised again in the learner by :meth:`check`."""

    def __init__(self, target: Callable[[], Any], name: str = "plane-player"):
        self._error: Dict[str, BaseException] = {}
        self.stop = threading.Event()

        def _run():
            try:
                target()
            except PlaneClosed:
                pass
            except BaseException as e:
                self._error["error"] = e

        self._thread = threading.Thread(target=_run, daemon=True, name=name)

    def start(self) -> "LocalPlayerHandle":
        self._thread.start()
        return self

    def check(self) -> None:
        if "error" in self._error:
            raise RuntimeError("decoupled player thread crashed") from self._error["error"]

    def alive(self) -> bool:
        return self._thread.is_alive()

    def join(self, timeout: float = 30.0) -> None:
        self.stop.set()
        self._thread.join(timeout=timeout)

"""Async checkpoint persistence: double-buffered background writes
(counterpart of ``sheeprl_tpu/ckpt/saver.py``).

The Check-N-Run / t5x split: the step path pays only for the device→host
snapshot; serialization and disk I/O run on a dedicated writer thread. The
buffering discipline is *double* buffering — at most one save in flight, and
a new request first waits for the previous one to land (bounding host memory
at two snapshots and guaranteeing saves hit disk in step order) instead of
stacking a queue the filesystem can't drain.

Failure policy: every write runs under a bounded-retry/backoff wrapper
(transient filesystem hiccups — NFS timeouts, ENOSPC races with GC — get
``retries`` attempts). If a background write still fails, the saver marks
itself degraded and subsequent saves run *synchronously on the caller's
thread*, so persistent storage trouble surfaces in the train loop as a
raised exception instead of checkpoints silently stopping.
"""

from __future__ import annotations

import threading
import time
import warnings
from typing import Callable, Optional


__all__ = ["AsyncSaver"]


class AsyncSaver:
    def __init__(self, retries: int = 3, backoff_s: float = 0.5):
        self.retries = max(0, int(retries))
        self.backoff_s = float(backoff_s)
        self._submit_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._degraded = False
        self.last_error: Optional[BaseException] = None
        #: totals over the saver's life: writes, failed writes, bytes, write time
        self.stats = {"writes": 0, "failed": 0, "bytes": 0, "write_ms": 0.0}

    def _account(self, t0: float, nbytes: int, failed: bool = False) -> None:
        self.stats["writes" if not failed else "failed"] += 1
        self.stats["bytes"] += int(nbytes)
        self.stats["write_ms"] += (time.perf_counter() - t0) * 1000.0

    # -- internals ----------------------------------------------------------

    def _attempt(self, write_fn: Callable[[], int], label: str) -> None:
        """Run ``write_fn`` under retry/backoff; accounts ``stats``.
        Raises the final error after exhausting retries."""
        t0 = time.perf_counter()
        delay = self.backoff_s
        for attempt in range(self.retries + 1):
            try:
                nbytes = write_fn()
                self._account(t0, nbytes or 0)
                return
            except OSError as exc:
                self.last_error = exc
                if attempt >= self.retries:
                    self._account(t0, 0, failed=True)
                    raise
                warnings.warn(
                    f"checkpoint write {label} failed (attempt {attempt + 1}/"
                    f"{self.retries + 1}): {exc}; retrying in {delay:.1f}s"
                )
                time.sleep(delay)
                delay *= 2

    def _run_background(self, write_fn: Callable[[], int], label: str) -> None:
        try:
            self._attempt(write_fn, label)
        except BaseException as exc:  # noqa: BLE001 - must not kill the writer thread
            self._degraded = True
            self.last_error = exc
            warnings.warn(
                f"async checkpoint write {label} failed after "
                f"{self.retries + 1} attempts: {exc!r}; degrading to "
                "synchronous saves so further failures surface in the train loop"
            )

    # -- API ----------------------------------------------------------------

    @property
    def degraded(self) -> bool:
        return self._degraded

    def wait_for_inflight(self, timeout: Optional[float] = None) -> None:
        t = self._thread
        if t is not None:
            t.join(timeout)

    def submit(self, write_fn: Callable[[], int], label: str = "", sync: bool = False) -> None:
        """Persist one checkpoint. Async unless ``sync`` or degraded.

        Blocks only while a previous save is still in flight (double-buffer
        rule); the caller measures that wait as part of its blocked time.
        """
        with self._submit_lock:
            self.wait_for_inflight()
            self._thread = None
            if sync or self._degraded:
                self._attempt(write_fn, label)
                return
            try:
                thread = threading.Thread(
                    target=self._run_background,
                    args=(write_fn, label),
                    name="ckpt-writer",
                    daemon=True,
                )
                thread.start()
            except RuntimeError as exc:  # thread limit / interpreter teardown
                warnings.warn(f"cannot start checkpoint writer thread ({exc}); saving synchronously")
                self._attempt(write_fn, label)
                return
            self._thread = thread

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Wait for the in-flight save (if any). True when nothing is left."""
        self.wait_for_inflight(timeout)
        t = self._thread
        done = t is None or not t.is_alive()
        if done:
            self._thread = None
        return done

"""Atomic policy publication: trainer → readers in other threads or
processes (counterpart of ``policy_path``, ``PolicyPublisher`` and
``PolicyPoller`` in ``sheeprl_tpu/plane/publish.py``).

Each version is written by the checkpoint writer (``ckpt/writer.py``) as a
policy-only manifest checkpoint ``policy_<version>/``: into
``policy_<version>.tmp/``, fsynced, then renamed. A poller therefore sees a
whole, checksummed version or a ``.tmp`` partial that it skips. Versions are
strictly monotone and the oldest are deleted past ``keep_policies``.
"""

from __future__ import annotations

import os
import queue
import re
import shutil
import threading
import time
from typing import Any, Iterator, Optional, Tuple

__all__ = ["PlaneClosed", "PolicyPoller", "PolicyPublisher", "policy_path"]

_POLICY_RE = re.compile(r"^policy_(\d+)$")


class PlaneClosed(RuntimeError):
    """The channel is stopping: a blocked wait gives up."""


def policy_path(root: str, version: int) -> str:
    return os.path.join(root, f"policy_{int(version):08d}")


def _list_versions(root: str) -> Iterator[int]:
    try:
        names = os.listdir(root)
    except OSError:
        return
    for name in names:
        m = _POLICY_RE.match(name)  # a ``.tmp`` or ``.old`` suffix never matches
        if m:
            yield int(m.group(1))


class PolicyPublisher:
    """The trainer's side of the channel.

    ``async_publish=True`` moves the write, fsync, rename and clean-up onto
    one writer thread behind a bounded FIFO queue: ``publish`` checks the
    version, enqueues and returns, and every version still lands in order.
    A failure on the writer thread is raised by the next ``publish``.
    """

    def __init__(self, root: str, keep_policies: int = 4, algo: Optional[str] = None, async_publish: bool = False):
        self.root = os.path.abspath(root)
        self.keep = max(int(keep_policies), 2)
        self.algo = algo
        self._last: Optional[int] = None
        self._async = bool(async_publish)
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(self.root, exist_ok=True)

    def publish(self, version: int, params: Any) -> str:
        """Publish ``params`` (a tree of host arrays) as ``version``; returns
        the final path, which an asynchronous publication reaches shortly
        after this returns."""
        version = int(version)
        if self._last is not None and version <= self._last:
            raise ValueError(f"policy versions must be strictly monotone: got {version} after {self._last}")
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("policy publication failed on the writer thread") from err
        if self._async:
            if self._queue is None:
                self._queue = queue.Queue(maxsize=8)
                self._thread = threading.Thread(target=self._worker, name="policy-publisher", daemon=True)
                self._thread.start()
            self._queue.put((version, params))
        else:
            self._write(version, params)
        self._last = version
        return policy_path(self.root, version)

    def _write(self, version: int, params: Any) -> None:
        from sheeprl_tpu_torch.ckpt.manager import FRAMEWORK
        from sheeprl_tpu_torch.ckpt.writer import write_checkpoint

        write_checkpoint(
            policy_path(self.root, version),
            {"params": params, "version": version},
            step=version,
            algo=self.algo,
            framework=FRAMEWORK,
        )
        for v in sorted(_list_versions(self.root))[: -self.keep]:
            shutil.rmtree(policy_path(self.root, v), ignore_errors=True)

    def _worker(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            try:
                self._write(*item)
            except BaseException as exc:  # raised by the next publish()
                self._error = exc

    def close(self, timeout: float = 30.0) -> None:
        """Flush pending publications and stop the writer thread."""
        if self._thread is not None:
            self._queue.put(None)
            self._thread.join(timeout=timeout)
            self._thread = None


class PolicyPoller:
    """The reader's side: poll the directory, load checksummed versions, and
    report a torn or corrupt one as None so the caller keeps what it has."""

    def __init__(self, root: str, poll_interval_s: float = 0.05):
        self.root = os.path.abspath(root)
        self.poll_interval_s = max(float(poll_interval_s), 0.005)
        self._cache: Tuple[Optional[int], Any] = (None, None)

    def latest_version(self) -> Optional[int]:
        versions = sorted(_list_versions(self.root))
        return versions[-1] if versions else None

    def load(self, version: int) -> Optional[Any]:
        """The params of ``version`` (numpy leaves), or None when the
        directory is missing or fails its checksums."""
        from sheeprl_tpu_torch.ckpt.manifest import CheckpointCorruptedError
        from sheeprl_tpu_torch.ckpt.resume import read_checkpoint

        cached_v, cached = self._cache
        if cached_v == int(version):
            return cached
        try:
            params = read_checkpoint(policy_path(self.root, version), verify=True)["params"]
        except (CheckpointCorruptedError, OSError, KeyError, ValueError):
            return None
        self._cache = (int(version), params)
        return params

    def wait_min_version(self, min_version: int, stop=None, use_exact: bool = True) -> Tuple[int, Any]:
        """Block until a valid version ``>= min_version`` exists; returns
        ``(version, params)``: the smallest such version with ``use_exact``,
        else the newest. Raises :class:`PlaneClosed` when ``stop`` is set
        while waiting."""
        min_version = max(int(min_version), 0)
        while True:
            eligible = [v for v in sorted(_list_versions(self.root)) if v >= min_version]
            if not use_exact:
                eligible = eligible[-1:]
            for v in eligible:
                params = self.load(v)
                if params is not None:
                    return v, params
            if stop is not None and stop.is_set():
                raise PlaneClosed("stopping while waiting for a policy version")
            time.sleep(self.poll_interval_s)

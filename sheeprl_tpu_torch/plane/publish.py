"""Atomic policy publication: trainer → readers in other threads or
processes (counterpart of ``sheeprl_tpu/plane/publish.py``).

Each version is written by the checkpoint writer (``ckpt/writer.py``) as a
policy-only manifest checkpoint ``policy_<version>/``: into
``policy_<version>.tmp/``, fsynced, then renamed. A poller therefore sees a
whole, checksummed version or a ``.tmp`` partial that it skips. Versions are
strictly monotone and the oldest are deleted past ``keep_policies``.

The actor–learner plane moves a version every update, where that path (a
manifest, an npz and their fsyncs to write, a checksum to read back, a
directory to poll) takes ~10 ms: its channels keep the same contract
(monotone versions, ``wait_min_version``) in memory.
:class:`LocalPolicyChannel` serves the thread transport
(``plane.num_players=0``), :class:`SharedPolicyChannel` the player processes.
"""

from __future__ import annotations

import os
import queue
import re
import shutil
import signal
import threading
import time
import traceback
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np

from sheeprl_tpu_torch.plane.slabs import PlaneClosed

__all__ = ["LocalPolicyChannel", "PlaneClosed", "PolicyPoller", "PolicyPublisher", "SharedPolicyChannel",
           "policy_path"]

_POLICY_RE = re.compile(r"^policy_(\d+)$")


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

    ``async_publish=True`` moves the write, fsync, rename and clean-up off
    the caller behind a bounded FIFO queue of 8: ``publish`` checks the
    version, enqueues (blocking while 8 versions wait) and returns, and
    every version still lands, in order. A failed write is raised by a later
    ``publish``. The writer is a thread, or with ``mp_context``
    ``WRITER_PROCESSES`` processes of that multiprocessing context: a write
    is a few ms of Python and filesystem calls (the npz, the manifest),
    which a thread takes from the trainer's own under the GIL, at every
    version where the actor–learner plane publishes one an update. The
    processes stage versions side by side (``ckpt.writer.stage_checkpoint``)
    and commit them (the rename, the clean-up of old versions) one at a
    time in the order they were published.
    """

    #: writer processes of an ``mp_context`` publisher
    WRITER_PROCESSES = 2

    def __init__(self, root: str, keep_policies: int = 4, algo: Optional[str] = None, async_publish: bool = False,
                 mp_context=None):
        self.root = os.path.abspath(root)
        self.keep = max(int(keep_policies), 2)
        self.algo = algo
        self._last: Optional[int] = None
        self._async = bool(async_publish)
        self._mp = mp_context
        self._queue: Any = None
        self._thread: Optional[threading.Thread] = None
        self._procs: list = []
        self._errors: Any = None
        self._seq = 0
        self._error: Optional[BaseException] = None
        os.makedirs(self.root, exist_ok=True)

    def publish(self, version: int, params: Any) -> str:
        """Publish ``params`` (a tree of host arrays) as ``version``; returns
        the final path, which an asynchronous publication reaches shortly
        after this returns."""
        version = int(version)
        if self._last is not None and version <= self._last:
            raise ValueError(f"policy versions must be strictly monotone: got {version} after {self._last}")
        self._raise_writer_error()
        if self._async:
            if self._queue is None:
                self._start_writer()
            if self._procs:
                self._put_checked((self._seq, version, params))
                self._seq += 1
            else:
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
        self._collect_old()

    def _collect_old(self) -> None:
        for v in sorted(_list_versions(self.root))[: -self.keep]:
            shutil.rmtree(policy_path(self.root, v), ignore_errors=True)

    def _start_writer(self) -> None:
        if self._mp is None:
            self._queue = queue.Queue(maxsize=8)
            self._thread = threading.Thread(target=self._worker, name="policy-publisher", daemon=True)
            self._thread.start()
            return
        self._queue, self._errors = self._mp.Queue(maxsize=8), self._mp.Queue()
        # held here for the writers' lives: the children rebuild them from their names after start() returns
        self._turn, self._cond = self._mp.Value("q", 0, lock=False), self._mp.Condition()
        for k in range(self.WRITER_PROCESSES):
            proc = self._mp.Process(target=_writer_main, name=f"policy-publisher-{k}", daemon=True,
                                    args=(self.root, self.keep, self.algo, self._queue, self._errors, self._turn,
                                          self._cond, os.getpid()))
            proc.start()
            self._procs.append(proc)

    def _put_checked(self, item) -> None:
        """Enqueue for the writer processes, blocking while 8 versions wait;
        a writer that died raises instead of a wait without end."""
        while True:
            try:
                self._queue.put(item, timeout=0.5)
                return
            except queue.Full:
                dead = [p.name for p in self._procs if not p.is_alive()]
                if dead:
                    raise RuntimeError(f"policy writer processes died: {dead}")

    def _raise_writer_error(self) -> None:
        if self._errors is not None:
            try:
                raise RuntimeError(f"policy publication failed in the writer process:\n{self._errors.get_nowait()}")
            except queue.Empty:
                pass
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("policy publication failed on the writer thread") from err

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
        """Flush pending publications and stop the writer. A writer process
        still alive after ``timeout`` is killed: it ignores SIGTERM, and one
        left running would hold its parent's exit, which joins it."""
        if self._thread is not None:
            self._queue.put(None)
            self._thread.join(timeout=timeout)
            self._thread = None
        if self._procs:
            for _ in self._procs:
                self._queue.put(None)
            deadline = time.monotonic() + timeout
            for proc in self._procs:
                proc.join(timeout=max(deadline - time.monotonic(), 0.5))
                if proc.is_alive():
                    proc.kill()
                    proc.join(timeout=5.0)
            self._procs = []
            for q in (self._queue, self._errors):
                q.cancel_join_thread()
                q.close()


def _writer_main(root: str, keep: int, algo: Optional[str], items, errors, turn, cond, parent_pid: int) -> None:
    """A writer process: stages each version it takes from ``items``, then
    waits for its turn (``turn`` holds the sequence number to commit next,
    guarded by ``cond``) to commit it and collect old versions, until the
    ``None`` that closes it or until its parent is gone. A failed write is
    put on ``errors`` and its turn passed on. It ignores SIGTERM and SIGINT:
    the trainer owns the preemption drain and closes it."""
    from sheeprl_tpu_torch.ckpt.manager import FRAMEWORK
    from sheeprl_tpu_torch.ckpt.writer import commit_checkpoint, stage_checkpoint

    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    publisher = PolicyPublisher(root, keep_policies=keep, algo=algo)
    # under forkserver the observed parent is the forkserver, which dies with the trainer
    observed_parent = os.getppid()

    def orphaned() -> bool:
        return os.getppid() != observed_parent or not _alive(parent_pid)

    while True:
        try:
            item = items.get(timeout=1.0)
        except queue.Empty:
            if orphaned():
                return
            continue
        if item is None:
            return
        seq, version, params = item
        failure = None
        try:
            stage_checkpoint(policy_path(root, version), {"params": params, "version": version}, step=version,
                             algo=algo, framework=FRAMEWORK)
        except BaseException:
            failure = traceback.format_exc(limit=8)
        with cond:
            while turn.value != seq:
                cond.wait(timeout=1.0)
                if orphaned():
                    return
            try:
                if failure is None:
                    commit_checkpoint(policy_path(root, version))
                    publisher._collect_old()
            except BaseException:
                failure = traceback.format_exc(limit=8)
            finally:
                turn.value = seq + 1
                cond.notify_all()
        if failure is not None:
            errors.put(failure)


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


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


class LocalPolicyChannel:
    """The channel inside one process: monotone versions and the same
    ``wait_min_version`` over a dict and a condition variable. The
    publisher hands over host arrays it no longer writes."""

    def __init__(self, keep_policies: int = 4):
        self.keep = max(int(keep_policies), 2)
        self._versions: Dict[int, Any] = {}
        self._cv = threading.Condition()
        self._last: Optional[int] = None

    def publish(self, version: int, params: Any) -> None:
        version = int(version)
        with self._cv:
            if self._last is not None and version <= self._last:
                raise ValueError(f"policy versions must be strictly monotone: got {version} after {self._last}")
            self._versions[version] = params
            self._last = version
            for v in sorted(self._versions)[: -self.keep]:
                del self._versions[v]
            self._cv.notify_all()

    def wait_min_version(self, min_version: int, stop=None, use_exact: bool = True) -> Tuple[int, Any]:
        min_version = max(int(min_version), 0)
        with self._cv:
            while True:
                eligible = sorted(v for v in self._versions if v >= min_version)
                if eligible:
                    v = eligible[0] if use_exact else eligible[-1]
                    return v, self._versions[v]
                if stop is not None and stop.is_set():
                    raise PlaneClosed("plane stopping while waiting for a policy version")
                self._cv.wait(timeout=0.2)


class SharedPolicyChannel:
    """The process plane's channel: the newest ``keep_policies`` versions'
    host arrays in shared memory (one ``multiprocessing.RawArray`` a key,
    ``[keep, *shape]``, the publications written round the slots). The learner is
    its one writer; a slot carries a sequence count, odd while the slot is
    written, so that a reader keeps a copy only if the count was even and
    unchanged around it. No lock is shared: a player killed in the middle of
    a read leaves nothing held. Made by the learner, its layout that of the
    first publication, and passed whole to every player process (a
    respawned player finds the newest versions there). At
    ``plane.max_policy_lag=0`` the protocol never lets the learner lead a
    player by ``keep >= 2`` versions, so the exact version a player waits
    for is still held."""

    #: a waiting reader's poll interval (s)
    POLL_S = 0.001

    def __init__(self, ctx, example: Mapping[str, Any], keep_policies: int = 4):
        self.keep = max(int(keep_policies), 2)
        self._layout = tuple((k, tuple(np.shape(v)), np.asarray(v).dtype.str) for k, v in example.items())
        self._raw = {k: ctx.RawArray("b", max(int(np.prod((self.keep, *shape), dtype=np.int64)) * np.dtype(dt).itemsize,
                                             1))
                     for k, shape, dt in self._layout}
        self._versions = ctx.RawArray("q", [-1] * self.keep)
        self._seq = ctx.RawArray("q", [0] * self.keep)
        self._last: Optional[int] = None
        self._published = 0
        self._views: Optional[Dict[str, np.ndarray]] = None

    def _slots(self) -> Dict[str, np.ndarray]:
        if self._views is None:
            self._views = {k: np.frombuffer(self._raw[k], dtype=np.dtype(dt),
                                            count=int(np.prod((self.keep, *shape), dtype=np.int64))
                                            ).reshape((self.keep, *shape))
                           for k, shape, dt in self._layout}
        return self._views

    def publish(self, version: int, params: Mapping[str, Any]) -> None:
        version = int(version)
        if self._last is not None and version <= self._last:
            raise ValueError(f"policy versions must be strictly monotone: got {version} after {self._last}")
        slot = self._published % self.keep
        self._seq[slot] += 1  # odd: being written
        self._versions[slot] = -1
        for k, view in self._slots().items():
            view[slot] = np.asarray(params[k])
        self._versions[slot] = version
        self._seq[slot] += 1
        self._last = version
        self._published += 1

    def _read(self, version: int) -> Optional[Dict[str, np.ndarray]]:
        slot = list(self._versions).index(version) if version in self._versions else -1
        if slot < 0:
            return None
        seq = self._seq[slot]
        if seq % 2 or self._versions[slot] != version:
            return None
        params = {k: view[slot].copy() for k, view in self._slots().items()}
        return params if self._seq[slot] == seq and self._versions[slot] == version else None

    def wait_min_version(self, min_version: int, stop=None, use_exact: bool = True) -> Tuple[int, Any]:
        """Poll until a version ``>= min_version`` is held; returns
        ``(version, params)``, a copy: the smallest such version with
        ``use_exact``, else the newest. Raises :class:`PlaneClosed` when
        ``stop`` is set while waiting."""
        min_version = max(int(min_version), 0)
        while True:
            eligible = sorted(v for v in self._versions if v >= min_version)
            for v in eligible if use_exact else eligible[::-1]:
                params = self._read(v)
                if params is not None:
                    return v, params
            if stop is not None and stop.is_set():
                raise PlaneClosed("plane stopping while waiting for a policy version")
            time.sleep(self.POLL_S)

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_views"] = None  # views are per process
        return state

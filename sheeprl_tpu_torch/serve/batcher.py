"""Request coalescing: concurrent ``act(obs)`` requests → one batched dispatch
(counterpart of ``sheeprl_tpu/serve/batcher.py``).

A dispatcher thread collects pending requests and runs **one**
``model.act`` per batch: when ``max_batch`` rows are waiting or the oldest
request's deadline (``deadline_s``) has passed, whichever comes first.

Determinism: rows are stacked in submission order, and every dispatch draws
its noise from one ``torch.Generator`` on the model's device, seeded with
``seed`` (the JAX batcher splits a ``PRNGKey(seed)`` once per dispatch):
the eval service's schedule (``evals/service.py``). A caller that routes
each row of an eval pool through its own client, one full batch a pool
step, reproduces the service's returns bit for bit at matched seeds.

Recurrent state stays on the server, per client, as device tensors: the
rows of a batch are concatenated for the dispatch and the new state is split
back afterwards. ``reset=True`` starts a client from a fresh state row.

``swap`` replaces the model between dispatches: a batch in flight finishes
on the model it started with, whose actions are on the host before the
batch's requests are answered, and every response carries the version that
produced it. A cancelled request is dropped at dispatch; a dispatch that
raises fails only its own requests; ``drain`` refuses new requests,
finishes the queue, waits for the device and stops the thread, and fails
loudly whatever is still queued at its timeout.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from sheeprl_tpu_torch.obs.hist import StreamingHist

__all__ = ["RequestBatcher", "ServeClosed", "ServeRequestError"]

#: the stages of a request's life on the server
STAGE_NAMES = ("queue_wait", "batch_assembly", "device_dispatch", "respond")


class ServeClosed(RuntimeError):
    """The gateway is draining or closed and takes no new requests."""


class ServeRequestError(RuntimeError):
    """A request failed: its batch's dispatch raised, or it was abandoned."""


class _Pending:
    """One queued request: the ticket a client waits on."""

    __slots__ = ("client_id", "obs", "reset", "t_submit", "event", "action", "version", "error", "cancelled")

    def __init__(self, client_id: str, obs: Dict[str, np.ndarray], reset: bool):
        self.client_id = client_id
        self.obs = obs
        self.reset = bool(reset)
        self.t_submit = time.perf_counter()
        self.event = threading.Event()
        self.action: Optional[np.ndarray] = None
        self.version: Optional[int] = None
        self.error: Optional[BaseException] = None
        self.cancelled = False


def _stack_obs(rows: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([np.asarray(r[k]) for r in rows]) for k in rows[0]}


def _concat_states(rows: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {k: torch.cat([r[k] for r in rows], dim=0) for k in rows[0]}


def _split_states(state: Dict[str, torch.Tensor], n: int) -> List[Dict[str, torch.Tensor]]:
    return [{k: v[i : i + 1] for k, v in state.items()} for i in range(n)]


class RequestBatcher:
    """Fill-or-deadline coalescer around one servable model.

    ``model`` exposes ``act(obs, state, generator) -> (actions, new_state)``
    batched on axis 0, ``init_state_rows(n)`` (None for stateless families),
    ``version`` and ``device`` — a :class:`~sheeprl_tpu_torch.serve.model.GatewayModel`.
    """

    def __init__(self, model, max_batch: int = 64, deadline_s: float = 0.010, seed: int = 42):
        if int(max_batch) < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_batch = int(max_batch)
        self.deadline_s = max(float(deadline_s), 0.0)
        self._model = model
        self._seed = int(seed)
        self._generator: Optional[torch.Generator] = None
        self._cv = threading.Condition(threading.Lock())
        self._queue: List[_Pending] = []
        self._states: Dict[str, Dict[str, torch.Tensor]] = {}
        self._draining = False
        self._stopped = False
        self._abandoned = False
        self._latency = StreamingHist()
        self._stage_hists = {name: StreamingHist() for name in STAGE_NAMES}
        self._occupancy = StreamingHist()
        self._stats_lock = threading.Lock()
        self._requests = 0
        self._batches = 0
        self._batch_rows = 0
        self._deadline_misses = 0
        self._failed = 0
        self._swaps = 0
        self._versions_served: List[int] = []
        self._per_version: Dict[int, Dict[str, Any]] = {}
        self._last_deadline_miss: Optional[Dict[str, float]] = None
        self._thread = threading.Thread(target=self._run, name="serve-batcher", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- client API

    def submit(self, client_id: str, obs: Dict[str, np.ndarray], reset: bool = False) -> _Pending:
        """Queue one observation row; returns the ticket to :meth:`wait` on."""
        pending = _Pending(str(client_id), obs, reset)
        with self._cv:
            if self._draining or self._stopped:
                raise ServeClosed("gateway is draining: no new requests accepted")
            self._queue.append(pending)
            self._cv.notify_all()
        with self._stats_lock:
            self._requests += 1
        return pending

    def wait(self, pending: _Pending, timeout: Optional[float] = None):
        """Block until the ticket's batch ran; returns ``(action_row, version)``
        or raises :class:`ServeRequestError`."""
        if not pending.event.wait(timeout):
            raise TimeoutError("serve request timed out waiting for its batch")
        if pending.error is not None:
            raise ServeRequestError(str(pending.error)) from pending.error
        return pending.action, pending.version

    def cancel(self, pending: _Pending) -> None:
        """Client disconnect: the request is dropped at dispatch time."""
        pending.cancelled = True
        with self._cv:
            self._cv.notify_all()

    def forget_client(self, client_id: str) -> None:
        """Drop a disconnected client's server-side recurrent state."""
        with self._cv:
            self._states.pop(str(client_id), None)

    def state_of(self, client_id: str) -> Optional[Dict[str, torch.Tensor]]:
        """The client's current server-side state row (None before its first
        answered request)."""
        with self._cv:
            return self._states.get(str(client_id))

    # ------------------------------------------------------------ gateway API

    @property
    def model(self):
        return self._model

    def attach_ops(self, ops) -> None:
        """Install the request-path observability sink. The port has none
        yet (tracing, access log, SLO feed: ROADMAP queue A items 6g/6h), so
        only None (no sink) is taken."""
        if ops is not None:
            raise NotImplementedError("the serving ops surface is ROADMAP queue A items 6g/6h")

    def swap(self, model) -> int:
        """Install ``model`` for every later dispatch; a batch in flight
        finishes on the old one. Returns the new version."""
        self._model = model  # atomic reference assignment
        with self._stats_lock:
            self._swaps += 1
        return int(model.version)

    def drain(self, timeout: float = 30.0) -> bool:
        """Refuse new requests, finish the queued ones, stop the dispatcher
        and wait for the device. A request still queued after ``timeout``
        fails with :class:`ServeClosed` there and then (the batch in flight
        finishes). Returns True when the queue drained in time."""
        with self._cv:
            self._draining = True
            self._cv.notify_all()
        deadline = time.perf_counter() + float(timeout)
        while time.perf_counter() < deadline:
            with self._cv:
                if not self._queue:
                    break
            time.sleep(0.005)
        with self._cv:
            self._abandoned = True  # the dispatcher takes no further batch
            leftovers = list(self._queue)
            self._queue.clear()
        for p in leftovers:  # fail loud, never hang clients
            p.error = ServeClosed("gateway stopped before this request dispatched")
            p.event.set()
        with self._stats_lock:
            self._failed += len(leftovers)
        self.close()
        device = getattr(self._model, "device", None)
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        return not leftovers

    def close(self) -> None:
        with self._cv:
            self._draining = True
            self._stopped = True
            self._cv.notify_all()
        if self._thread.is_alive():
            self._thread.join(timeout=30.0)

    def stats(self) -> Dict[str, Any]:
        occ = self._occupancy
        occupancy_dist = {
            "count": occ.n,
            "p50": round(occ.quantile(0.5) or 0.0, 3),
            "p95": round(occ.quantile(0.95) or 0.0, 3),
            "p99": round(occ.quantile(0.99) or 0.0, 3),
            "max": round(occ.max, 3),
        }
        stage_latency = {name: h.percentiles() for name, h in self._stage_hists.items()}
        with self._stats_lock:
            batches = self._batches
            return {
                "requests": self._requests,
                "batches": batches,
                "mean_batch_occupancy": round(self._batch_rows / batches, 3) if batches else 0.0,
                "deadline_misses": self._deadline_misses,
                "failed_requests": self._failed,
                "swaps": self._swaps,
                "versions_served": list(self._versions_served),
                "act_latency": self._latency.percentiles(),
                "stage_latency": stage_latency,
                "batch_occupancy": occupancy_dist,
                "versions": {
                    str(v): {"requests": rec["requests"], **rec["latency"].percentiles()}
                    for v, rec in sorted(self._per_version.items())
                },
                "last_deadline_miss": self._last_deadline_miss,
            }

    # ------------------------------------------------------------- dispatcher

    def _collect(self) -> List[_Pending]:
        """Block until a batch is ready (full, deadline passed, or draining).
        Returns [] only when stopped with an empty queue."""
        with self._cv:
            while True:
                if self._abandoned:
                    return []
                while not self._queue:
                    if self._stopped or self._draining:
                        return []
                    self._cv.wait(timeout=0.05)
                remaining = self.deadline_s - (time.perf_counter() - self._queue[0].t_submit)
                if self._draining or len(self._queue) >= self.max_batch or remaining <= 0:
                    batch = self._queue[: self.max_batch]
                    del self._queue[: len(batch)]
                    return batch
                self._cv.wait(timeout=remaining)

    def _run(self) -> None:
        while True:
            batch = self._collect()
            if not batch:
                return
            self._dispatch(batch)

    def _batch_states(self, batch: List[_Pending], model) -> Optional[Dict[str, torch.Tensor]]:
        """The batch's state rows: fresh where the client is new or reset."""
        rows = []
        for p in batch:
            state = None if p.reset else self._states.get(p.client_id)
            if state is None:
                state = model.init_state_rows(1)
                if state is None:
                    return None  # stateless family
            rows.append(state)
        return _concat_states(rows)

    def _generator_for(self, device: torch.device) -> torch.Generator:
        gen = self._generator
        if gen is None or gen.device != device:
            gen = self._generator = torch.Generator(device=device).manual_seed(self._seed)
        return gen

    def _dispatch(self, batch: List[_Pending]) -> None:
        t_collect = time.perf_counter()
        # a miss is a late launch (the previous batch still running), not a
        # partial fill at the deadline, which is by design
        lateness = t_collect - (batch[0].t_submit + self.deadline_s)
        deadline_miss = self.deadline_s > 0 and lateness > 0.5 * self.deadline_s
        live = [p for p in batch if not p.cancelled]
        if not live:
            return
        model = self._model  # one read: the whole batch rides one model
        try:
            obs = _stack_obs([p.obs for p in live])
            with self._cv:
                state = self._batch_states(live, model)
            generator = self._generator_for(model.device)
            t_model = time.perf_counter()
            actions, new_state = model.act(obs, state, generator)
            actions = np.asarray(actions)
        except Exception as exc:  # fail this batch's waiters, keep serving
            for p in live:
                p.error = exc
                p.event.set()
            with self._stats_lock:
                self._failed += len(live)
            return
        t_done = time.perf_counter()
        if new_state is not None:
            with self._cv:
                for p, row in zip(live, _split_states(new_state, len(live))):
                    self._states[p.client_id] = row
        version = int(model.version)
        for i, p in enumerate(live):
            p.action = actions[i]
            p.version = version
            p.event.set()
        t_end = time.perf_counter()
        with self._stats_lock:
            ver_rec = self._per_version.setdefault(version, {"requests": 0, "latency": StreamingHist()})
            ver_rec["requests"] += len(live)
        for p in live:
            ver_rec["latency"].record(t_end - p.t_submit)
            self._latency.record(t_end - p.t_submit)
            self._stage_hists["queue_wait"].record(t_collect - p.t_submit)
            self._stage_hists["batch_assembly"].record(t_model - t_collect)
            self._stage_hists["device_dispatch"].record(t_done - t_model)
            self._stage_hists["respond"].record(t_end - t_done)
        self._occupancy.record(len(live))
        with self._stats_lock:
            self._batches += 1
            self._batch_rows += len(live)
            self._deadline_misses += int(deadline_miss)
            if not self._versions_served or self._versions_served[-1] != version:
                self._versions_served.append(version)
        if deadline_miss:
            self._flag_deadline_miss(len(live), lateness)

    def _flag_deadline_miss(self, rows: int, lateness_s: float) -> None:
        """Keep the latest late launch for ``stats`` (the JAX batcher arms its
        run's flight recorder here; the port's is ROADMAP queue A item 6h)."""
        with self._stats_lock:
            self._last_deadline_miss = {
                "rows": int(rows),
                "lateness_ms": round(lateness_s * 1e3, 3),
                "deadline_ms": round(self.deadline_s * 1e3, 3),
            }

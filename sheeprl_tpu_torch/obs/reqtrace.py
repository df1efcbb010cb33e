"""Per-request tracing for the serving tier (counterpart of
``sheeprl_tpu/obs/reqtrace.py``, the same spans, lanes and sampling).

A sampled ``act()`` request carries one trace id from the client call site
through the slab ring or the batcher's queue to the dispatch, and lands as a
six-stage span chain in the Chrome-trace plane::

    client_enqueue -> ring_transit -> queue_wait -> batch_assembly
                   -> device_dispatch -> respond

The first two stages are drawn on a **client lane** (a Perfetto pid of its
own) and the last four on a **gateway lane**, written as
``trace_serve_client.jsonl`` and ``trace_serve_gateway.jsonl``; both carry
the ``clock_sync`` anchor and ``process_name`` metadata, so
``sheeprl_tpu_torch/tools/trace_view.py`` merges them with a run's trace on
one clock. Every stamp is ``time.perf_counter()`` (CLOCK_MONOTONIC on Linux
is system-wide), so the stamps a ring client wrote in another process
compare directly with the gateway's.

Sampling is deterministic: every k-th request for ``serve.trace_sample_rate
= 1/k``, so a seeded run traces the same requests. With no tracer installed
:func:`sample` is one global read returning None.

The module imports no torch: a ring client process imports it.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, Optional

__all__ = [
    "CLIENT_PID",
    "GATEWAY_PID",
    "STAGES",
    "RequestTrace",
    "ServeTracer",
    "install",
    "installed",
    "now",
    "sample",
    "sample_every",
    "unix_now",
]

#: the six stages of a request, in causal order
STAGES = (
    "client_enqueue",
    "ring_transit",
    "queue_wait",
    "batch_assembly",
    "device_dispatch",
    "respond",
)

#: Perfetto track ids of the two serve lanes (a run's learner is pid 0, its
#: players and env workers small offsets)
GATEWAY_PID = 9000
CLIENT_PID = 9100


def now() -> float:
    """Monotonic seconds: the clock of every serve timestamp."""
    return time.perf_counter()


def unix_now() -> float:
    """Wall-clock seconds, for records a person reads (access log, alerts)."""
    return time.time()


def sample_every(rate: float) -> int:
    """k of "every k-th request" for a sampling ``rate`` (0: none)."""
    rate = max(0.0, min(float(rate), 1.0))
    if rate >= 1.0:
        return 1
    return max(1, round(1.0 / rate)) if rate > 0 else 0


class RequestTrace:
    """A request's baton: its trace id and the two client-side stamps. It
    rides ``_Pending`` through the batcher (in-process clients) or the
    ring's per-slot metadata (clients in other processes); the spans are
    written once, on the gateway, when the request's batch retires."""

    __slots__ = ("trace_id", "t_start", "t_enqueue")

    def __init__(self, trace_id: int, t_start: float, t_enqueue: float = 0.0):
        self.trace_id = int(trace_id)
        self.t_start = float(t_start)
        self.t_enqueue = float(t_enqueue)


class ServeTracer:
    """The two-lane trace writer and the deterministic sampler."""

    def __init__(self, out_dir: str, sample_rate: float, flight_ring=None):
        from sheeprl_tpu_torch.obs.spans import TraceWriter

        self.sample_rate = max(0.0, min(float(sample_rate), 1.0))
        self._every = sample_every(self.sample_rate)
        self._lock = threading.Lock()
        self._seen = 0
        self.sampled = 0
        os.makedirs(out_dir, exist_ok=True)
        self.client = TraceWriter(
            path=os.path.join(out_dir, "trace_serve_client.jsonl"),
            xla_annotations=False,
            ring=flight_ring,
            pid=CLIENT_PID,
            process_name="serve_client",
        )
        # one origin for both lanes: their spans order without relying on the clock_sync anchors' precision
        self.gateway = TraceWriter(
            path=os.path.join(out_dir, "trace_serve_gateway.jsonl"),
            xla_annotations=False,
            ring=flight_ring,
            pid=GATEWAY_PID,
            process_name="serve_gateway",
            origin=self.client._origin,
        )

    @property
    def every(self) -> int:
        """k: every k-th request is traced (0: none)."""
        return self._every

    def sample(self) -> Optional[RequestTrace]:
        """A fresh :class:`RequestTrace` for every k-th request, else None."""
        if self._every <= 0:
            return None
        with self._lock:
            self._seen += 1
            if (self._seen - 1) % self._every:
                return None
            trace_id = self._seen
        return RequestTrace(trace_id, t_start=now())

    def emit_request(
        self,
        trace: RequestTrace,
        t_submit: float,
        t_collect: float,
        t_model: float,
        t_done: float,
        t_end: float,
        client_id: str = "",
        version: int = 0,
    ) -> None:
        """Write the six-stage chain of one retired request."""
        from sheeprl_tpu_torch.obs.counters import add_serve_traced

        args: Dict[str, Any] = {"trace_id": trace.trace_id}
        if client_id:
            args["client"] = str(client_id)
        if version:
            args["version"] = int(version)
        t_enqueue = trace.t_enqueue or trace.t_start
        self.client.complete("serve/client_enqueue", "serve", trace.t_start, t_enqueue, args=args)
        self.client.complete("serve/ring_transit", "serve", t_enqueue, t_submit, args=args)
        self.gateway.complete("serve/queue_wait", "serve", t_submit, t_collect, args=args)
        self.gateway.complete("serve/batch_assembly", "serve", t_collect, t_model, args=args)
        self.gateway.complete("serve/device_dispatch", "serve", t_model, t_done, args=args)
        self.gateway.complete("serve/respond", "serve", t_done, t_end, args=args)
        with self._lock:
            self.sampled += 1
        add_serve_traced(1)

    def close(self) -> None:
        self.client.close()
        self.gateway.close()


_TRACER: Optional[ServeTracer] = None


def install(tracer: Optional[ServeTracer]) -> None:
    """Make ``tracer`` the process's serve tracer (None: tracing off)."""
    global _TRACER
    _TRACER = tracer


def installed() -> Optional[ServeTracer]:
    return _TRACER


def sample() -> Optional[RequestTrace]:
    """The client side's entry: this request's baton, or None (one global
    read when tracing is off)."""
    tracer = _TRACER
    return None if tracer is None else tracer.sample()

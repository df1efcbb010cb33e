"""Steps replayed from CUDA graphs: the port's counterpart of the JAX
package's one-dispatch programs (``jax.jit`` of a whole step or burst).

A :class:`CapturedStep` wraps a function of no arguments that reads and
writes only tensors whose addresses do not change (static inputs, the
modules' parameters, their gradients and the optimizers' state). On the
card its first ``WARMUP_CALLS`` calls run eagerly on a side stream, as a
capture needs (cuBLAS and cuDNN workspaces, autograd's device threads);
they are real calls, counted like any other, and each is waited for, so
that ``warmup_s`` holds their own time. The next call captures the function
into one graph, and every call from then on replays it on the current
stream, so the host launches the whole step once instead of kernel by
kernel. The function's outputs at capture are the graph's static outputs:
every replay overwrites them. A capture that fails raises; nothing falls
back to eager. On the CPU every call runs the function eagerly: the device
decides, not a flag.

The kernel wrappers count their launches on the host. A capture runs no
kernel, so its counts are taken back (``kernels.ops.launches_recorded``)
and added again on every replay.

With the run telemetry on, a capture counts as ``recompiles`` (its warm-up
and capture seconds as ``compile_secs``) and a replay as ``graph_replays``
(``obs/counters.py``); a train step (``train=True``) counts its FLOPs and
bytes on its first eager call (``obs.perf.count_cost``), once a run, never
inside a capture. Neither adds a launch or a synchronisation.

While a ``torch.profiler`` session records, every call (eager or replayed)
runs inside a ``record_function("step:<name>")`` range, the port's
counterpart of a jitted program's name in an XLA trace: the trace parser
(``obs/prof/trace.py``) attributes the device work a call launched to the
step by that name. Outside a session the range costs one flag read.

A train step of a data-parallel rank (``train=True`` inside a world,
``sheeprl_tpu_torch.parallel``) holds its collectives: NCCL's are captured
with the rest of the step (the communicator was built by an eager
collective at the rendezvous, and the warm-up calls run them eagerly
first); gloo's are host collectives, which no graph can hold, so with a
gloo world the train step runs eagerly on every call. That is a property
of the backend, not a fallback: ``eager_backend`` names it (``gloo``, else
None) and the run's ``graphs`` counts report it. A capture that fails
still raises.

Nothing may destroy a CUDA graph while another is captured: the
destruction is not permitted then, and it invalidates the capture (a
DreamerV3 run's first capture failed so, ``cudaErrorStreamCaptureInvalidated``
after PyTorch's "operation not permitted when stream is capturing
(function reset)": an earlier step's graph, left in a reference cycle,
finalized by the garbage collector in the middle of the capture).
``torch.cuda.graph`` collects before a capture only under
``torch.compiler.config.force_cudagraph_gc``, so a capture here collects
the garbage first and keeps the collector off until it ends
(:func:`capture_guard`).
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Any, Callable, Iterator, Optional

import torch

from sheeprl_tpu_torch.kernels import ops
from sheeprl_tpu_torch.obs import counters as _counters

__all__ = ["CapturedStep", "STEP_PREFIX", "WARMUP_CALLS", "capture_guard"]

#: the profiler range a step's calls run in: ``step:<name>``
STEP_PREFIX = "step:"

#: eager calls before the capture (PyTorch's recipe for whole-network capture)
WARMUP_CALLS = 3


@contextlib.contextmanager
def capture_guard() -> Iterator[None]:
    """Around a CUDA-graph capture: the garbage collected first and the
    collector off until the block ends."""
    gc.collect()
    collecting = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if collecting:
            gc.enable()


def _eager_backend(device: torch.device, train: bool) -> Optional[str]:
    """``gloo`` for a train step on the card in a gloo world, else None."""
    from sheeprl_tpu_torch.parallel import current_world

    world = current_world()
    if train and device.type == "cuda" and world is not None and not world.capturable:
        return world.backend
    return None


def _profiling() -> bool:
    return torch.autograd._profiler_enabled()


class CapturedStep:
    """``name`` labels the step's calls in a profiler trace (``train_step``
    for a train step, ``step`` otherwise, unless given)."""

    def __init__(self, fn: Callable[[], Any], device, *, train: bool = False, name: Optional[str] = None):
        self._fn = fn
        self.device = torch.device(device)
        self.train = bool(train)
        self.name = name or ("train_step" if self.train else "step")
        #: the FLOPs and bytes of one call, counted on the first eager call of a train step while the telemetry
        #: asks for them
        self.flops: Optional[int] = None
        self.bytes: Optional[int] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._out: Any = None
        self._recorded: Optional[ops.Recorded] = None
        self._side: Optional[torch.cuda.Stream] = None
        #: eager calls (all calls on the CPU), replays, and the host seconds the
        #: warm-up calls (each waited for on the device) and the capture took
        self.eager_calls = 0
        self.replays = 0
        self.warmup_s = 0.0
        self.capture_s = 0.0
        #: the world's backend when its collectives keep this train step eager on the card (gloo), else None
        self.eager_backend = _eager_backend(self.device, self.train)

    def __call__(self) -> Any:
        if _profiling():
            with torch.profiler.record_function(STEP_PREFIX + self.name):
                return self._call()
        return self._call()

    def _call(self) -> Any:
        if self.device.type != "cuda" or self.eager_backend is not None:
            self.eager_calls += 1
            return self._eager()
        if self.graph is None and self.eager_calls < WARMUP_CALLS:
            return self._warm_up()
        if self.graph is None:
            self._capture()
        self.graph.replay()
        ops.add_recorded_launches(self._recorded)
        self.replays += 1
        _counters.add_graph_replays()
        return self._out

    def _eager(self) -> Any:
        if self.train and self.flops is None:
            from sheeprl_tpu_torch.obs.perf import count_cost, wants_train_flops

            if wants_train_flops():
                out, self.flops, self.bytes = count_cost(self._fn)
                return out
        return self._fn()

    def _warm_up(self) -> Any:
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(self.device)
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        self._side.wait_stream(current)
        with torch.cuda.stream(self._side):
            out = self._eager()
        current.wait_stream(self._side)
        self._side.synchronize()
        self.eager_calls += 1
        self.warmup_s += time.perf_counter() - t0
        return out

    def _capture(self) -> None:
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with capture_guard(), ops.launches_recorded() as recorded:
            # thread-local: the replay prefetch thread keeps copying on its own stream meanwhile
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                out = self._fn()
        self.graph, self._out, self._recorded = graph, out, recorded
        self.capture_s = time.perf_counter() - t0
        _counters.add_graph_capture(self.warmup_s + self.capture_s)

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

__all__ = ["CapturedStep", "WARMUP_CALLS", "capture_guard"]

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


class CapturedStep:
    def __init__(self, fn: Callable[[], Any], device):
        self._fn = fn
        self.device = torch.device(device)
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

    def __call__(self) -> Any:
        if self.device.type != "cuda":
            self.eager_calls += 1
            return self._fn()
        if self.graph is None and self.eager_calls < WARMUP_CALLS:
            return self._warm_up()
        if self.graph is None:
            self._capture()
        self.graph.replay()
        ops.add_recorded_launches(self._recorded)
        self.replays += 1
        return self._out

    def _warm_up(self) -> Any:
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(self.device)
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        self._side.wait_stream(current)
        with torch.cuda.stream(self._side):
            out = self._fn()
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

"""Named-scope wall-clock timing (counterpart of ``sheeprl_tpu/utils/timer.py``).

``with timer("Time/train_time"): ...`` accumulates seconds into a global
registry, disable-able as a whole (the CLI sets ``timer.disabled`` at
``metric.log_level=0`` or ``metric.disable_timer``); ``compute()`` returns
the totals and resets, once a log boundary (``obs.perf.log_sps_metrics``).
A scope registers its name when it is made, and one that loses its entry
to a reset while it runs registers a fresh one on exit. Device work is
asynchronous: a timed block measures the device only where it
synchronises.
"""

from __future__ import annotations

import threading
import time
from contextlib import ContextDecorator
from typing import Dict, Optional

from sheeprl_tpu_torch.utils.metric import SumMetric

__all__ = ["timer"]


class timer(ContextDecorator):
    disabled: bool = False
    timers: Dict[str, SumMetric] = {}
    _lock = threading.Lock()

    def __init__(self, name: str, metric: Optional[SumMetric] = None):
        self.name = name
        self._metric = metric
        if not timer.disabled:
            with timer._lock:
                if name not in timer.timers:
                    timer.timers[name] = metric if metric is not None else SumMetric()

    def __enter__(self):
        if not timer.disabled:
            self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if not timer.disabled:
            elapsed = time.perf_counter() - self._start
            with timer._lock:
                if self.name not in timer.timers:  # the registry was reset mid-scope
                    # a fresh metric: the original may already have been computed
                    timer.timers[self.name] = SumMetric(getattr(self._metric, "sync_on_compute", False))
                timer.timers[self.name].update(elapsed)
        return False

    @classmethod
    def compute(cls) -> Dict[str, float]:
        """Accumulated seconds per name; resets the registry."""
        with cls._lock:
            out = {name: metric.compute() for name, metric in cls.timers.items()}
            cls.timers = {}
        return out

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls.timers = {}

"""Named-scope wall-clock timing (counterpart of ``sheeprl_tpu/utils/timer.py``).

``with timer("Time/train_time"): ...`` accumulates seconds into a global
registry, disable-able as a whole; ``compute()`` returns the totals and
resets. Device work is asynchronous: a timed block measures the device only
where it synchronises.
"""

from __future__ import annotations

import threading
import time
from contextlib import ContextDecorator
from typing import Dict

from sheeprl_tpu_torch.utils.metric import SumMetric

__all__ = ["timer"]


class timer(ContextDecorator):
    disabled: bool = False
    timers: Dict[str, SumMetric] = {}
    _lock = threading.Lock()

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if not timer.disabled:
            self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if not timer.disabled:
            elapsed = time.perf_counter() - self._start
            with timer._lock:
                timer.timers.setdefault(self.name, SumMetric()).update(elapsed)
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

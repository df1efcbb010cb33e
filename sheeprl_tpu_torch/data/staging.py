"""Replay staging: host buffer → device batch (counterpart of ``HostStaging``
and ``make_replay_staging`` in ``sheeprl_tpu/data/staging.py``).

``sample_device(...)`` samples a burst ``[n_samples, T, B, ...]`` on the
host (a per-env sequence buffer or the episode buffer, each through its own
``sample`` arguments), copies it into page-locked host memory (on a CUDA
device) and from there to the device with ``non_blocking=True``, so the
copy overlaps the host's next work. The copy is enqueued on the producing
thread's current stream; the caller's current stream waits for it (an
event), so a consumer on any stream sees the whole burst. With ``buffer.prefetch=True`` a worker thread prepares the
next burst of the same shape while the caller trains on the current one
(sampling under a lock shared with the buffer's ``add``, cloning the rows);
``buffer.prefetch=False`` samples on the caller's thread, and then the draws
are bitwise the JAX package's stream for the same adds and seed.

``buffer.device_ring=True`` (the TPU's device-resident mirror of the
buffer, ``RingStaging``) is not ported and raises (ROADMAP queue A item 6d).
"""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, EpisodeBuffer

__all__ = ["HostStaging", "make_replay_staging"]

# burst spec: (batch_size, sequence_length, n_samples, sample_next_obs)
_Spec = Tuple[int, int, int, bool]


class HostStaging:
    """``rb.sample`` → pinned host tensors → device, optionally one burst
    ahead on a worker thread. A spec is prefetched once it has been asked
    for twice (the steady state), so one-off bursts leave nothing behind."""

    def __init__(self, rb: Any, device: torch.device, *, sequence_mode: bool, prefetch: bool = True):
        self.rb = rb
        self.device = torch.device(device)
        self._seq = bool(sequence_mode)
        self._lock = threading.RLock()
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pending: Dict[_Spec, Future] = {}
        self._spec_counts: Dict[_Spec, int] = {}
        if prefetch:
            rb.bind_write_lock(self._lock)
            self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="replay-prefetch")
        #: bursts served from a finished prefetch, and sampled on the caller's thread
        self.prefetch_hits = 0
        self.prefetch_misses = 0

    def _produce(self, spec: _Spec, clone: bool) -> Tuple[Dict[str, torch.Tensor], Optional[torch.cuda.Event]]:
        batch_size, seq_len, n_samples, sample_next_obs = spec
        with self._lock:
            if self._seq:
                np_batch = self.rb.sample(batch_size, n_samples=n_samples, sequence_length=seq_len, clone=clone)
            else:
                np_batch = self.rb.sample(batch_size, sample_next_obs=sample_next_obs, clone=clone, n_samples=n_samples)
        pin = self.device.type == "cuda"
        out = {}
        for k, v in np_batch.items():
            host = torch.from_numpy(np.ascontiguousarray(v))
            if pin:
                host = host.pin_memory()
            out[k] = host.to(self.device, non_blocking=pin)
        copied = None
        if pin:
            copied = torch.cuda.Event()
            copied.record(torch.cuda.current_stream(self.device))
        return out, copied

    def sample_device(
        self,
        batch_size: int,
        *,
        sequence_length: Optional[int] = None,
        n_samples: int = 1,
        sample_next_obs: bool = False,
    ) -> Dict[str, torch.Tensor]:
        """The burst as device tensors, native dtypes (uint8 pixels)."""
        spec: _Spec = (int(batch_size), int(sequence_length or 0), int(n_samples), bool(sample_next_obs))
        if self._pool is None:
            return self._consume(self._produce(spec, clone=False))
        fut = self._pending.pop(spec, None)
        produced = None
        if fut is not None:
            try:
                produced = fut.result()
                self.prefetch_hits += 1
            except Exception:
                produced = None  # a genuine sampling error re-raises below, on this thread
        if produced is None:
            self.prefetch_misses += 1
            produced = self._produce(spec, clone=True)
        self._spec_counts[spec] = self._spec_counts.get(spec, 0) + 1
        if self._spec_counts[spec] >= 2:
            self._pending[spec] = self._pool.submit(self._produce, spec, True)
        return self._consume(produced)

    def _consume(self, produced) -> Dict[str, torch.Tensor]:
        """The caller's current stream waits for the burst's copy."""
        batch, copied = produced
        if copied is not None:
            torch.cuda.current_stream(self.device).wait_event(copied)
        return batch

    def force_done_last(self, env: int) -> None:
        """Mark env's most recent stored step terminal (the restart-on-exception patch)."""
        if not isinstance(self.rb, EnvIndependentReplayBuffer):
            raise NotImplementedError("force_done_last is only defined for per-env sequence buffers")
        with self._lock:
            sub = self.rb.buffer[env]
            last = (sub._pos - 1) % sub.buffer_size
            sub["dones"][last] = np.ones_like(sub["dones"][last])
            if "is_first" in sub:
                sub["is_first"][last] = np.zeros_like(sub["is_first"][last])

    def close(self) -> None:
        if self._pool is not None:
            for fut in self._pending.values():
                fut.cancel()
            self._pending.clear()
            self._pool.shutdown(wait=True)
            self._pool = None


def make_replay_staging(cfg: Any, fabric: Any, rb: Any, *, seed: Optional[int] = None) -> HostStaging:
    """Seed the buffer's sampler (``seed``) and stage it to ``fabric.device``."""
    if bool(cfg.buffer.get("device_ring", False)):
        raise NotImplementedError(
            "buffer.device_ring=True mirrors the replay buffer in device memory: ROADMAP queue A item 6d; "
            "the port stages from the host (pass buffer.device_ring=False)"
        )
    if seed is not None:
        rb.seed(int(seed))
    return HostStaging(
        rb,
        fabric.device,
        sequence_mode=isinstance(rb, (EnvIndependentReplayBuffer, EpisodeBuffer)),
        prefetch=bool(cfg.buffer.get("prefetch", True)),
    )

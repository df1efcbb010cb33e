"""The flat transitions ring in device memory (counterpart of
``DeviceRingTransitions`` and ``scatter_append`` in
``sheeprl_tpu/data/device_ring.py``).

The ring holds ``[capacity, n_envs, ...]`` tensors on the device and serves
the flat uniform-replay loops (SAC) their ``[n_samples, batch, ...]``
batches without a host copy: the rollout engine
(:mod:`sheeprl_tpu_torch.envs.rollout.engine`) appends each burst's rows
inside its captured graph with :func:`scatter_append` at the device write
head :attr:`DeviceRingTransitions.pos`, and a sample is drawn on the device
from the ring's own ``torch.Generator`` and gathered there. The wrapped host
:class:`~sheeprl_tpu_torch.data.buffers.ReplayBuffer` keeps the ring
counters (its write head and ``full``) and is the checkpoint's storage: the
device rows are copied into it only when a checkpoint reads it
(:meth:`DeviceRingTransitions.sync_host`), and a restored buffer is copied
back to the device (:meth:`DeviceRingTransitions.load_state_dict`).

The valid window is the host buffer's: every written row, less the newest
one under ``sample_next_obs`` (it has no stored successor), whose
``next_<key>`` rows are gathered at ``(t + 1) % capacity``. Dreamer's
per-env sequence ring is not ported.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from sheeprl_tpu_torch.data.buffers import ReplayBuffer

__all__ = ["DeviceRingTransitions", "scatter_append"]


def scatter_append(bufs: Dict[str, torch.Tensor], pos: torch.Tensor, rows: Dict[str, torch.Tensor],
                   capacity: int) -> None:
    """Write ``rows`` (``[T, n_envs, ...]``) into ``bufs`` (``[capacity,
    n_envs, ...]``) at slots ``(pos + t) % capacity``, in place; ``pos`` is a
    device scalar, so a captured graph reads the head as it stands at each
    replay. A burst longer than the ring raises: its slots would repeat
    within one write."""
    t = int(next(iter(rows.values())).shape[0])
    if t > capacity:
        raise ValueError(f"scatter_append burst of {t} rows exceeds the ring capacity {capacity}; split the burst")
    t_idx = torch.remainder(pos + torch.arange(t, device=pos.device, dtype=pos.dtype), capacity)
    for k, buf in bufs.items():
        buf.index_copy_(0, t_idx, rows[k].to(buf.dtype))


class DeviceRingTransitions:
    """A flat replay ring on ``device`` over ``host_rb``'s geometry;
    ``generator`` (on ``device``) draws its samples."""

    def __init__(self, host_rb: ReplayBuffer, device, generator: torch.Generator):
        if not isinstance(host_rb, ReplayBuffer) or hasattr(host_rb, "_plan_starts"):
            raise TypeError("DeviceRingTransitions wraps a flat ReplayBuffer")
        self._rb = host_rb
        self.device = torch.device(device)
        self._generator = generator
        self._capacity = int(host_rb.buffer_size)
        self._bufs: Optional[Dict[str, torch.Tensor]] = None
        #: the device write head, ``host_rb``'s once every write is adopted
        self.pos = torch.zeros((), dtype=torch.int64, device=self.device)
        self._host_stale = False
        if not host_rb.empty:
            self._remirror_from_host()

    # -- the host buffer's surface ---------------------------------------------

    @property
    def host(self) -> ReplayBuffer:
        return self._rb

    @property
    def buffer_size(self) -> int:
        return self._capacity

    @property
    def n_envs(self) -> int:
        return self._rb.n_envs

    @property
    def full(self) -> bool:
        return self._rb.full

    @property
    def buffers(self) -> Optional[Dict[str, torch.Tensor]]:
        """The device storage (None before the first write)."""
        return self._bufs

    # -- writes ----------------------------------------------------------------

    def allocate(self, example_rows: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Device storage from per-env rows ``[n_envs, ...]`` (once; the
        addresses never change after, so a captured writer keeps them)."""
        if self._bufs is None:
            self._bufs = {
                k: torch.zeros((self._capacity,) + tuple(np.shape(v)), dtype=torch.as_tensor(v).dtype,
                               device=self.device)
                for k, v in example_rows.items()
            }
        return self._bufs

    def advance(self, steps: int, example_rows: Dict[str, Any]) -> None:
        """Adopt ``steps`` rows a device writer appended at :attr:`pos`: the
        host counters advance (its rows go stale until :meth:`sync_host`)."""
        self._rb.advance_external({k: np.asarray(torch.as_tensor(v).cpu()) for k, v in example_rows.items()},
                                  int(steps))
        self._host_stale = True

    def add(self, data: Dict[str, np.ndarray]) -> None:
        """Append ``[T, n_envs, ...]`` host rows: one copy to the device and a
        scatter at the write head (only the trailing ``capacity`` rows of a
        longer insert, as the host buffer keeps)."""
        data = {k: np.asarray(v) for k, v in data.items()}
        steps = int(next(iter(data.values())).shape[0])
        self.allocate({k: v[0] for k, v in data.items()})
        write = min(steps, self._capacity)
        rows = {k: torch.as_tensor(np.ascontiguousarray(v[steps - write:])).to(self.device) for k, v in data.items()}
        scatter_append(self._bufs, self.pos + (steps - write), rows, self._capacity)
        self.pos.copy_(torch.remainder(self.pos + steps, self._capacity))
        self.advance(steps, {k: v[0] for k, v in data.items()})

    # -- samples ---------------------------------------------------------------

    def sample_device(self, batch_size: int, sample_next_obs: bool = False, n_samples: int = 1,
                      **_: Any) -> Dict[str, torch.Tensor]:
        """``[n_samples, batch_size, ...]`` transitions drawn uniformly from
        the valid window on the device: the time slot and the env from the
        ring's generator, the rows gathered in device memory."""
        if batch_size <= 0 or n_samples <= 0:
            raise ValueError(f"'batch_size' ({batch_size}) and 'n_samples' ({n_samples}) must be both greater than 0")
        pos, full = int(self._rb._pos), bool(self._rb.full)
        if self._bufs is None or (not full and pos == 0):
            raise ValueError("No sample has been added to the buffer")
        n_valid = (self._capacity if full else pos) - int(bool(sample_next_obs))
        if n_valid <= 0:
            raise RuntimeError(
                "You want to sample the next observations, but only one sample has been added to the buffer. "
                "Make sure that at least two samples are added."
            )
        # the oldest row first: a full ring's valid window starts at the write head
        start = pos if (full and sample_next_obs) else 0
        total = int(batch_size) * int(n_samples)
        r = torch.randint(0, n_valid, (total,), generator=self._generator, device=self.device)
        e_idx = torch.randint(0, self.n_envs, (total,), generator=self._generator, device=self.device)
        t_idx = torch.remainder(r + start, self._capacity)
        out: Dict[str, torch.Tensor] = {}
        obs_keys = self._rb._obs_keys
        for k, buf in self._bufs.items():
            out[k] = buf[t_idx, e_idx].reshape((n_samples, batch_size) + tuple(buf.shape[2:]))
            if sample_next_obs and k in obs_keys:
                nxt = buf[torch.remainder(t_idx + 1, self._capacity), e_idx]
                out[f"next_{k}"] = nxt.reshape((n_samples, batch_size) + tuple(buf.shape[2:]))
        return out

    # -- checkpoints -------------------------------------------------------------

    def sync_host(self) -> None:
        """Copy the written device rows into the host buffer if device writes
        left it stale (a checkpoint's ``state_dict`` does it first)."""
        if not self._host_stale or self._bufs is None:
            return
        n_rows = self._capacity if self._rb.full else int(self._rb._pos)
        for k, buf in self._bufs.items():
            self._rb.buffer[k][:n_rows] = buf[:n_rows].cpu().numpy()
        self._host_stale = False

    def state_dict(self) -> Dict[str, Any]:
        self.sync_host()
        return self._rb.state_dict()

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore the host buffer, then copy its rows to the device."""
        self._rb.load_state_dict(state)
        self._remirror_from_host()

    def _remirror_from_host(self) -> None:
        host = self._rb.buffer
        if host is None:
            return
        self.allocate({k: np.asarray(v)[0] for k, v in host.items()})
        for k, v in host.items():
            self._bufs[k].copy_(torch.as_tensor(np.asarray(v)))
        self.pos.fill_(int(self._rb._pos))
        self._host_stale = False

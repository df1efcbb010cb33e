"""Partitioned host replay: N single-writer ring shards behind one facade
(counterpart of ``sheeprl_tpu/replay/sharded.py``).

Each plane player owns a shard (a plain
:class:`~sheeprl_tpu_torch.data.buffers.ReplayBuffer` whose env columns are
that player's envs), so writers never share a ring position, and the
learner samples across the shards through a facade with the buffer's
surface (``add``, ``sample``, ``seed``, ``state_dict``, ``bind_write_lock``).

A burst of ``total`` rows is apportioned over the shards in proportion to
their fill (valid rows × env columns, largest remainders, no rng), each
shard's part is planned by the sampling strategy, and the gathered rows are
interleaved by a permutation from the facade's rng, so that no gradient
step of a burst sees one shard's block.

Seeding: one shard keeps ``s`` itself (the facade's rng ``s + 1`` is never
drawn from); with N shards shard ``i`` gets ``s + i`` and the facade
``s + N``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from sheeprl_tpu_torch.obs.counters import set_replay_shard_fill
from sheeprl_tpu_torch.replay.strategies import SamplingStrategy, UniformStrategy

__all__ = ["ShardedReplay", "apportion_by_fill"]


def apportion_by_fill(total: int, weights: Sequence[float]) -> List[int]:
    """Split ``total`` draws in proportion to ``weights`` (largest
    remainders, ties to the lowest index); no rng is drawn. A zero weight
    gets nothing."""
    weights = [max(float(w), 0.0) for w in weights]
    wsum = sum(weights)
    if total <= 0:
        return [0] * len(weights)
    if wsum <= 0.0:
        raise ValueError("No shard holds data to sample from")
    quotas = [total * w / wsum for w in weights]
    counts = [int(q) for q in quotas]
    order = sorted(range(len(weights)), key=lambda i: (-(quotas[i] - counts[i]), i))
    for i in order[: total - sum(counts)]:
        counts[i] += 1
    return counts


class ShardedReplay:
    """The facade over N single-writer shards, sampled through a strategy."""

    def __init__(self, shards: Sequence[Any], strategy: Optional[SamplingStrategy] = None):
        if not shards:
            raise ValueError("ShardedReplay needs at least one shard")
        self._shards: List[Any] = list(shards)
        self._strategy: SamplingStrategy = strategy or UniformStrategy()
        self._rng: np.random.Generator = np.random.default_rng()
        # each shard's first column in the global env axis
        self._env_offsets = np.cumsum([0] + [s.n_envs for s in self._shards])
        # the last burst's plan in output row order: (shard, t_idx, e_idx local to the shard)
        self._last_plan: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
        self._last_weights: Optional[np.ndarray] = None

    # -- the buffer's surface -------------------------------------------------

    @property
    def shards(self) -> List[Any]:
        return self._shards

    @property
    def n_shards(self) -> int:
        return len(self._shards)

    @property
    def strategy(self) -> SamplingStrategy:
        return self._strategy

    @property
    def needs_writeback(self) -> bool:
        return self._strategy.needs_writeback

    @property
    def buffer_size(self) -> int:
        return sum(s.buffer_size for s in self._shards)

    @property
    def n_envs(self) -> int:
        return sum(s.n_envs for s in self._shards)

    @property
    def full(self) -> bool:
        return all(s.full for s in self._shards)

    @property
    def empty(self) -> bool:
        return all(s.empty for s in self._shards)

    def seed(self, seed: Optional[int] = None) -> None:
        n = len(self._shards)
        if n == 1:
            self._shards[0].seed(seed)
            self._rng = np.random.default_rng(None if seed is None else seed + 1)
            return
        self._rng = np.random.default_rng(None if seed is None else seed + n)
        for i, s in enumerate(self._shards):
            s.seed(None if seed is None else seed + i)

    def bind_write_lock(self, lock: Any) -> None:
        for s in self._shards:
            s.bind_write_lock(lock)

    # -- adds -----------------------------------------------------------------

    def add_shard(self, shard: int, data: Dict[str, np.ndarray]) -> None:
        """One writer's ``[T, shard_envs, ...]`` rows into its shard (and the
        run telemetry's fill gauge of that shard)."""
        self._shards[shard].add(data)
        if len(self._shards) > 1:
            new = self._shards[shard]
            set_replay_shard_fill({str(shard): 1.0 if new.full else new._pos / new.buffer_size})

    def add(self, data: Dict[str, np.ndarray]) -> None:
        """A whole fleet's ``[T, n_envs, ...]`` rows, split along the env
        axis by shard (a coupled loop's single collector)."""
        for p in range(len(self._shards)):
            lo, hi = int(self._env_offsets[p]), int(self._env_offsets[p + 1])
            self.add_shard(p, {k: np.asarray(v)[:, lo:hi] for k, v in data.items()})

    def init_priorities_newest(self, shard: int, steps: int) -> None:
        """Mark ``shard``'s ``steps`` newest rows at the largest priority,
        right after their add, so that fresh rows are drawn soon."""
        s = self._shards[shard]
        if steps <= 0:
            return
        write_len = min(int(steps), s.buffer_size)
        start = s._pos - write_len
        self._strategy.init_priorities(s, np.arange(start, start + write_len) % s.buffer_size)

    # -- sampling -------------------------------------------------------------

    def _shard_weights(self, sample_next_obs: bool) -> List[float]:
        return [0.0 if s.empty or (not s.full and s._pos == 0)
                else len(s.valid_time_indices(sample_next_obs)) * float(s.n_envs) for s in self._shards]

    def plan_burst(self, total: int, sample_next_obs: bool = False) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Plan ``total`` rows across the shards: ``(shard_ids, t_idx,
        e_idx)`` in output order, ``e_idx`` local to each shard; the
        importance weights (prioritized strategies) normalized by the
        burst's largest."""
        counts = apportion_by_fill(total, self._shard_weights(sample_next_obs))
        weighted = self._strategy.needs_writeback
        shard_ids = np.empty(total, np.int64)
        t_all = np.empty(total, np.int64)
        e_all = np.empty(total, np.int64)
        w_all = np.empty(total, np.float64) if weighted else None
        cursor = 0
        for p, count in enumerate(counts):
            if count == 0:
                continue
            t_idx, e_idx = self._strategy.plan(self._shards[p], count, sample_next_obs=sample_next_obs, n_samples=1)
            shard_ids[cursor:cursor + count] = p
            t_all[cursor:cursor + count] = t_idx
            e_all[cursor:cursor + count] = e_idx
            if weighted:
                # raw weights in this shard's plan order: the permutation keeps them row for row
                w_all[cursor:cursor + count] = self._strategy.weights(self._shards[p], normalize=False)
            cursor += count
        if len(self._shards) > 1:
            perm = self._rng.permutation(total)
            shard_ids, t_all, e_all = shard_ids[perm], t_all[perm], e_all[perm]
            if weighted:
                w_all = w_all[perm]
        self._last_weights = (w_all / w_all.max()) if weighted else None
        return shard_ids, t_all, e_all

    def sample(self, batch_size: int, sample_next_obs: bool = False, clone: bool = False, n_samples: int = 1,
               **kwargs: Any) -> Dict[str, np.ndarray]:
        """``[n_samples, batch_size, ...]`` rows drawn across the shards."""
        if batch_size <= 0 or n_samples <= 0:
            raise ValueError(f"'batch_size' ({batch_size}) and 'n_samples' ({n_samples}) must be both greater than 0")
        total = batch_size * n_samples
        shard_ids, t_all, e_all = self.plan_burst(total, sample_next_obs)
        self._last_plan = (shard_ids, t_all, e_all)
        parts: Dict[str, np.ndarray] = {}
        for p in range(len(self._shards)):
            mask = shard_ids == p
            if not mask.any():
                continue
            rows = self._shards[p].gather_plan(t_all[mask], e_all[mask], sample_next_obs=sample_next_obs, clone=False)
            for k, v in rows.items():
                if k not in parts:
                    parts[k] = np.empty((total,) + v.shape[1:], v.dtype)
                parts[k][mask] = v
        return {k: v.reshape(n_samples, batch_size, *v.shape[1:]) for k, v in parts.items()}

    def last_weights(self) -> Optional[np.ndarray]:
        """The importance weights of the last burst's rows, flat (None when unweighted)."""
        return self._last_weights

    def update_priorities(self, td_errors: np.ndarray) -> None:
        """The last burst's TD errors (its flat row order) back through the
        strategy, each row to its shard."""
        if self._last_plan is None:
            raise RuntimeError("update_priorities called before any sample")
        shard_ids, t_all, e_all = self._last_plan
        td = np.asarray(td_errors).reshape(-1)
        if len(td) != len(shard_ids):
            raise ValueError(f"td_errors has {len(td)} rows but the last plan drew {len(shard_ids)}")
        for p in range(len(self._shards)):
            mask = shard_ids == p
            if mask.any():
                self._strategy.update_priorities(self._shards[p], t_all[mask], e_all[mask], td[mask])

    # -- checkpoints ----------------------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        return {"shards": [s.state_dict() for s in self._shards]}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        saved = state["shards"]
        if len(saved) != len(self._shards):
            raise ValueError(f"Checkpoint has {len(saved)} replay shards but the run is configured with "
                             f"{len(self._shards)}: replay.shards must match to resume")
        for s, sd in zip(self._shards, saved):
            s.load_state_dict(sd)

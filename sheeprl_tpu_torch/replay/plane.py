"""The replay plane's ingest: plane players' slabs into their shards
(counterpart of ``sheeprl_tpu/replay/plane.py``).

:class:`ReplayPlane` joins a running plane
(:class:`~sheeprl_tpu_torch.plane.supervisor.ProcessPlane` or
``LocalPlane``) to a :class:`~sheeprl_tpu_torch.replay.sharded.ShardedReplay`
whose partition is the plane's env split: player ``p``'s slab columns are
shard ``p``'s env columns (``shard_env_split`` equals ``plane_env_split``
when ``replay.shards == plane.num_players``), so every shard has one writer
and a burst lands with one copy a shard and no full-width concatenation.
With the run telemetry on, each shard's rows age from their own slab's
commit time, and a shard writer the supervisor started again fires the
flight recorder's ``replay_writer_restart``.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

from sheeprl_tpu_torch.obs.dist import staleness as _staleness

__all__ = ["ReplayPlane"]


class ReplayPlane:
    """Route each player's slab into its shard."""

    def __init__(self, plane: Any, sharded: Any):
        n_players, n_shards = int(getattr(plane, "n_players", 1)), int(sharded.n_shards)
        if n_players != n_shards:
            raise ValueError(f"replay.shards ({n_shards}) must equal plane.num_players ({n_players}) so each "
                             "player process owns exactly one shard")
        self._sharded = sharded
        self._plane = plane
        ledger = getattr(plane, "_restarts", None)
        self._restarts_seen: Optional[List[int]] = None if ledger is None else [int(c) for c in ledger]

    def ingest(self, handles: Sequence[Any], n_act: int) -> List[Tuple[float, float]]:
        """Add each player's rows ``[:n_act]`` to its shard, mark the newest
        rows at the largest priority when the strategy keeps priorities, and
        release the handle. Returns the episodes' stats in player order."""
        if len(handles) != self._sharded.n_shards:
            raise ValueError(f"got {len(handles)} slab handles for {self._sharded.n_shards} shards")
        n_act = int(n_act)
        ep_stats: List[Tuple[float, float]] = []
        for p, h in enumerate(handles):
            commit_ts = float(getattr(h, "commit_ts", 0.0) or 0.0)
            if commit_ts:
                _staleness.stamp_next_add(commit_ts)
            self._sharded.add_shard(p, {k: v[:n_act] for k, v in h.data.items()})
            if self._sharded.needs_writeback:
                self._sharded.init_priorities_newest(p, n_act)
            ep_stats.extend(h.ep_stats)
            h.release()
        self._observe_restarts()
        return ep_stats

    def _observe_restarts(self) -> None:
        """The flight recorder's ``replay_writer_restart`` for each shard
        writer the supervisor started again since the last ingest."""
        ledger = getattr(self._plane, "_restarts", None)
        if ledger is None or self._restarts_seen is None:
            return
        for p, count in enumerate(ledger):
            if p < len(self._restarts_seen) and count > self._restarts_seen[p]:
                self._restarts_seen[p] = int(count)
                from sheeprl_tpu_torch.obs.telemetry import get_telemetry

                telemetry = get_telemetry()
                if telemetry is not None and telemetry.flight is not None:
                    shard = self._sharded.shards[p] if hasattr(self._sharded, "shards") else None
                    fill = 0.0 if shard is None else (1.0 if shard.full else shard._pos / shard.buffer_size)
                    telemetry.flight.trigger("replay_writer_restart",
                                             {"shard": p, "restart": int(count), "shard_fill": float(fill)})

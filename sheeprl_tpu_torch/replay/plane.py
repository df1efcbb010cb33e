"""The replay plane's ingest: plane players' slabs into their shards
(counterpart of ``sheeprl_tpu/replay/plane.py``).

:class:`ReplayPlane` joins a running plane
(:class:`~sheeprl_tpu_torch.plane.supervisor.ProcessPlane` or
``LocalPlane``) to a :class:`~sheeprl_tpu_torch.replay.sharded.ShardedReplay`
whose partition is the plane's env split: player ``p``'s slab columns are
shard ``p``'s env columns (``shard_env_split`` equals ``plane_env_split``
when ``replay.shards == plane.num_players``), so every shard has one writer
and a burst lands with one copy a shard and no full-width concatenation.
The JAX package's staleness stamps and flight-recorder triggers wait for
the port's telemetry (ROADMAP queue A item 6h).
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

__all__ = ["ReplayPlane"]


class ReplayPlane:
    """Route each player's slab into its shard."""

    def __init__(self, plane: Any, sharded: Any):
        n_players, n_shards = int(getattr(plane, "n_players", 1)), int(sharded.n_shards)
        if n_players != n_shards:
            raise ValueError(f"replay.shards ({n_shards}) must equal plane.num_players ({n_players}) so each "
                             "player process owns exactly one shard")
        self._sharded = sharded

    def ingest(self, handles: Sequence[Any], n_act: int) -> List[Tuple[float, float]]:
        """Add each player's rows ``[:n_act]`` to its shard, mark the newest
        rows at the largest priority when the strategy keeps priorities, and
        release the handle. Returns the episodes' stats in player order."""
        if len(handles) != self._sharded.n_shards:
            raise ValueError(f"got {len(handles)} slab handles for {self._sharded.n_shards} shards")
        n_act = int(n_act)
        ep_stats: List[Tuple[float, float]] = []
        for p, h in enumerate(handles):
            self._sharded.add_shard(p, {k: v[:n_act] for k, v in h.data.items()})
            if self._sharded.needs_writeback:
                self._sharded.init_priorities_newest(p, n_act)
            ep_stats.extend(h.ep_stats)
            h.release()
        return ep_stats

"""The one place entrypoints get replay storage from (counterpart of
``make_replay_buffer`` in ``sheeprl_tpu/replay/factory.py``).

Ported: ``kind="sequential"`` (DreamerV3's: one
:class:`~sheeprl_tpu_torch.data.buffers.SequentialReplayBuffer` per env
behind an :class:`~sheeprl_tpu_torch.data.buffers.EnvIndependentReplayBuffer`,
whatever ``buffer.type`` says), ``kind="dreamer"`` with
``buffer.type=sequential`` (the same) or ``buffer.type=episode`` (an
:class:`~sheeprl_tpu_torch.data.buffers.EpisodeBuffer`), and
``kind="transition"`` at one shard with uniform sampling (a plain
:class:`~sheeprl_tpu_torch.data.buffers.ReplayBuffer`). Sizes are the JAX
package's: ``buffer.size // n_envs`` rows per env (``dry_run_size`` under
``dry_run``; ``size`` when given), floored at ``min_size``; the episode buffer holds that many
steps in all, floored at the sequence length alone, never at ``min_size``.
More than one shard and non-uniform strategies raise: ROADMAP queue A
item 6f.
"""

from __future__ import annotations

import os
from typing import Any, Optional, Sequence, Union

from sheeprl_tpu_torch.data.buffers import (
    EnvIndependentReplayBuffer,
    EpisodeBuffer,
    ReplayBuffer,
    SequentialReplayBuffer,
)

__all__ = ["make_replay_buffer"]


def make_replay_buffer(
    cfg: Any,
    fabric: Any,
    log_dir: Optional[str],
    *,
    n_envs: int,
    kind: str = "transition",
    obs_keys: Sequence[str] = ("observations",),
    size: Optional[int] = None,
    min_size: int = 1,
    dry_run_size: Optional[int] = None,
    sequence_length: Optional[int] = None,
) -> Union[ReplayBuffer, EnvIndependentReplayBuffer, EpisodeBuffer]:
    """Build the replay storage an entrypoint needs (see module docstring);
    ``size`` sets the rows per env outright (the on-policy rollout storage's
    ``buffer.size``); ``sequence_length`` is the episode buffer's."""
    if size is not None:
        base = int(size)
    elif bool(cfg.dry_run) and dry_run_size is not None:
        base = int(dry_run_size)
    else:
        base = int(cfg.buffer.size) // n_envs
    buffer_size = max(base, int(min_size))
    memmap = bool(cfg.buffer.memmap)
    memmap_dir = None if log_dir is None else os.path.join(log_dir, "memmap_buffer", f"rank_{int(fabric.global_rank)}")
    replay = dict(cfg.get("replay", None) or {})
    shards = int(replay.get("shards", 1) or 1)
    strategy = str(replay.get("strategy", "uniform") or "uniform")
    if shards != 1 or strategy != "uniform":
        raise NotImplementedError(
            f"replay.shards={shards} replay.strategy={strategy}: sharded and prioritized replay are "
            "ROADMAP queue A item 6f"
        )
    if kind in ("dreamer", "sequential"):
        buffer_type = "sequential" if kind == "sequential" else str(cfg.buffer.get("type", "sequential")).lower()
        if buffer_type == "episode":
            if sequence_length is None:
                raise ValueError("episode replay needs a 'sequence_length'")
            return EpisodeBuffer(
                max(base, int(sequence_length)),
                sequence_length=int(sequence_length),
                n_envs=n_envs,
                obs_keys=obs_keys,
                prioritize_ends=bool(cfg.buffer.get("prioritize_ends", False)),
                memmap=memmap,
                memmap_dir=memmap_dir,
            )
        if buffer_type != "sequential":
            raise ValueError(
                f"Unrecognized buffer type: must be one of `sequential` or `episode`, received: {buffer_type}"
            )
        return EnvIndependentReplayBuffer(
            buffer_size,
            n_envs=n_envs,
            obs_keys=obs_keys,
            memmap=memmap,
            memmap_dir=memmap_dir,
            buffer_cls=SequentialReplayBuffer,
        )
    if kind != "transition":
        raise ValueError(f"Unknown replay kind {kind!r}: must be `transition`, `sequential` or `dreamer`")
    return ReplayBuffer(buffer_size, n_envs, obs_keys=obs_keys, memmap=memmap, memmap_dir=memmap_dir)

"""The one place entrypoints get replay storage from (counterpart of
``sheeprl_tpu/replay/factory.py``).

Sizes are the JAX package's: ``buffer.size // n_envs`` rows per env
(``dry_run_size`` under ``dry_run``; ``size`` when given), floored at
``min_size``; the episode buffer holds that many steps in all, floored at
the sequence length alone, never at ``min_size``.

- ``kind="sequential"`` (DreamerV3's), or ``kind="dreamer"`` with
  ``buffer.type=sequential``: one
  :class:`~sheeprl_tpu_torch.data.buffers.SequentialReplayBuffer` per env
  behind an :class:`~sheeprl_tpu_torch.data.buffers.EnvIndependentReplayBuffer`;
  ``buffer.type=episode``: an
  :class:`~sheeprl_tpu_torch.data.buffers.EpisodeBuffer`.
- ``kind="transition"``: sampled transition replay joins the replay plane.
  ``replay.shards > 1`` splits the env axis over single-writer shards
  (:func:`shard_env_split`); a non-uniform ``replay.strategy`` puts even one
  shard behind the :class:`~sheeprl_tpu_torch.replay.sharded.ShardedReplay`
  facade so that the strategy plans. One shard with ``uniform`` is the
  plain :class:`~sheeprl_tpu_torch.data.buffers.ReplayBuffer`, as is the
  on-policy rollout storage (``sampled=False``).

Sequence and episode storage keep uniform sampling (a strategy warns) and
refuse shards.
"""

from __future__ import annotations

import os
import warnings
from typing import Any, List, Optional, Sequence, Union

from sheeprl_tpu_torch.data.buffers import (
    EnvIndependentReplayBuffer,
    EpisodeBuffer,
    ReplayBuffer,
    SequentialReplayBuffer,
)
from sheeprl_tpu_torch.replay.sharded import ShardedReplay
from sheeprl_tpu_torch.replay.strategies import make_strategy

__all__ = ["make_replay_buffer", "replay_config", "shard_env_split"]


def replay_config(cfg: Any) -> dict:
    """``cfg.replay`` as a plain dict (empty for a config without the group)."""
    try:
        replay = cfg.get("replay", None)
    except AttributeError:
        replay = getattr(cfg, "replay", None)
    return dict(replay) if replay else {}


def shard_env_split(n_envs: int, n_shards: int) -> List[int]:
    """Each shard's env columns: the env axis split as evenly as possible
    (the first ``n_envs % n_shards`` shards take one more), the split
    ``plane_env_split`` gives the players."""
    if n_shards <= 0:
        raise ValueError(f"'replay.shards' must be positive, got {n_shards}")
    if n_shards > n_envs:
        raise ValueError(f"'replay.shards' ({n_shards}) cannot exceed the env count ({n_envs})")
    base, extra = divmod(n_envs, n_shards)
    return [base + (1 if i < extra else 0) for i in range(n_shards)]


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
    sampled: bool = True,
    shards: Optional[int] = None,
) -> Union[ReplayBuffer, EnvIndependentReplayBuffer, EpisodeBuffer, ShardedReplay]:
    """Build the replay storage an entrypoint needs (see the module's
    docstring); ``size`` sets the rows per env outright (the on-policy
    rollout storage's ``buffer.size``, with ``sampled=False``);
    ``sequence_length`` is the episode buffer's; ``shards`` overrides
    ``replay.shards`` (the decoupled learner checks it against the plane)."""
    if size is not None:
        base = int(size)
    elif bool(cfg.dry_run) and dry_run_size is not None:
        base = int(dry_run_size)
    else:
        base = int(cfg.buffer.size) // n_envs
    buffer_size = max(base, int(min_size))
    memmap = bool(cfg.buffer.memmap)
    memmap_dir = None if log_dir is None else os.path.join(log_dir, "memmap_buffer", f"rank_{int(fabric.global_rank)}")
    replay = replay_config(cfg)
    strategy = str(replay.get("strategy", "uniform") or "uniform")
    if shards is None:
        shards = int(replay.get("shards", 1) or 1) if sampled else 1
    shards = int(shards)
    if kind in ("dreamer", "sequential") or not sampled:
        if sampled and strategy != "uniform":
            warnings.warn(f"replay.strategy={strategy!r} only applies to transition replay; {kind!r} storage keeps "
                          "uniform sampling (episode storage has its own buffer.prioritize_ends flag)", stacklevel=2)
        if shards != 1:
            raise ValueError(f"replay.shards={shards} is only supported for sampled transition replay, not "
                             f"{kind!r} storage")
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
    if not sampled or (shards == 1 and strategy == "uniform"):
        return ReplayBuffer(buffer_size, n_envs, obs_keys=obs_keys, memmap=memmap, memmap_dir=memmap_dir)
    shard_bufs = [
        ReplayBuffer(buffer_size, shard_envs, obs_keys=obs_keys, memmap=memmap,
                     memmap_dir=os.path.join(memmap_dir, f"shard_{p}") if memmap_dir is not None and shards > 1
                     else memmap_dir)
        for p, shard_envs in enumerate(shard_env_split(n_envs, shards))
    ]
    return ShardedReplay(shard_bufs, strategy=make_strategy(replay))

"""The replay factory and the sharded, prioritized replay plane
(counterpart of ``sheeprl_tpu/replay``). ``replay.shards=1`` with the
uniform strategy is the plain ``ReplayBuffer``: no facade is involved."""

from sheeprl_tpu_torch.replay.factory import make_replay_buffer, replay_config, shard_env_split
from sheeprl_tpu_torch.replay.plane import ReplayPlane
from sheeprl_tpu_torch.replay.sharded import ShardedReplay, apportion_by_fill
from sheeprl_tpu_torch.replay.strategies import (
    PrioritizeEndsStrategy,
    SamplingStrategy,
    TDPriorityStrategy,
    UniformStrategy,
    get_strategy,
    make_strategy,
    register_strategy,
)

__all__ = [
    "PrioritizeEndsStrategy",
    "ReplayPlane",
    "SamplingStrategy",
    "ShardedReplay",
    "TDPriorityStrategy",
    "UniformStrategy",
    "apportion_by_fill",
    "get_strategy",
    "make_replay_buffer",
    "make_strategy",
    "register_strategy",
    "replay_config",
    "shard_env_split",
]

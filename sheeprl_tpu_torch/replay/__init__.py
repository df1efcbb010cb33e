"""The replay factory (counterpart of ``sheeprl_tpu/replay``), single shard."""

from sheeprl_tpu_torch.replay.factory import make_replay_buffer

__all__ = ["make_replay_buffer"]

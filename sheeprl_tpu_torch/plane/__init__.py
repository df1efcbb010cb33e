"""The actor–learner plane (counterpart of ``sheeprl_tpu/plane``): N player
processes, each owning its slice of the envs through the worker pool,
stream fixed-layout trajectory slabs to the learner over shared-memory
rings with credited-slot backpressure, and load the policy versions the
learner publishes (:mod:`~sheeprl_tpu_torch.plane.publish`); or one player
thread does the same in the learner's process (``plane.num_players=0``).

- :mod:`~sheeprl_tpu_torch.plane.protocol`: the burst and version
  arithmetic both sides derive alone;
- :mod:`~sheeprl_tpu_torch.plane.slabs`: the slab rings;
- :mod:`~sheeprl_tpu_torch.plane.local`: the thread transport;
- :mod:`~sheeprl_tpu_torch.plane.publish`: the policy channels;
- :mod:`~sheeprl_tpu_torch.plane.worker`: the player process's start and
  the :class:`PlayerContext`;
- :mod:`~sheeprl_tpu_torch.plane.supervisor`: :class:`ProcessPlane` and
  :class:`LocalPlane`.

Importing the package loads no torch.
"""

from sheeprl_tpu_torch.plane.local import BurstPayload, LocalBurstQueue, LocalPlayerHandle
from sheeprl_tpu_torch.plane.protocol import burst_plan, required_version, train_gated_burst_plan, version_after
from sheeprl_tpu_torch.plane.publish import LocalPolicyChannel, PolicyPoller, PolicyPublisher, policy_path
from sheeprl_tpu_torch.plane.slabs import PlaneClosed, SlabHandle, SlabSpec, TrajSlabRing
from sheeprl_tpu_torch.plane.supervisor import (
    LocalPlane,
    ProcessPlane,
    build_plane,
    plane_env_split,
    resolve_plane_players,
)
from sheeprl_tpu_torch.plane.worker import LocalWriter, PlayerContext, SlabWriter, player_seed

__all__ = [
    "BurstPayload",
    "LocalBurstQueue",
    "LocalPlane",
    "LocalPlayerHandle",
    "LocalPolicyChannel",
    "LocalWriter",
    "PlaneClosed",
    "PlayerContext",
    "PolicyPoller",
    "PolicyPublisher",
    "ProcessPlane",
    "SlabHandle",
    "SlabSpec",
    "SlabWriter",
    "TrajSlabRing",
    "build_plane",
    "burst_plan",
    "plane_env_split",
    "player_seed",
    "policy_path",
    "required_version",
    "resolve_plane_players",
    "train_gated_burst_plan",
    "version_after",
]

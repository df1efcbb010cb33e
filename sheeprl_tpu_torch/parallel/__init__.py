"""Multi-device training (counterpart of ``sheeprl_tpu/parallel/``).

Data-parallel training over processes, one a device (ROADMAP queue A item
7a): :mod:`.launch` holds the world (:class:`~.launch.World`,
:func:`~.launch.current_world`), the local launch ``Fabric.launch`` uses,
the join of an external (``torchrun``) launch and the explicit
:func:`~.launch.spawn` for tests. The gradient all-reduce and every other
collective go through :mod:`sheeprl_tpu_torch.obs.dist.comms`. Parameter
sharding (``parallel.model_axis``, item 7c) and ring attention (item 7d)
are not ported."""

from sheeprl_tpu_torch.parallel.launch import (
    World,
    current_world,
    free_port,
    init_world,
    join_external,
    launch_local,
    shutdown_world,
    spawn,
)

__all__ = [
    "World",
    "current_world",
    "free_port",
    "init_world",
    "join_external",
    "launch_local",
    "shutdown_world",
    "spawn",
]

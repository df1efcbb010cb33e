"""Device envs and the rollout engine behind ``env.backend=jax``
(counterpart of ``sheeprl_tpu/envs/rollout``): the whole collection burst,
act, env step, auto-reset and ring append, is one CUDA graph replay. The
JAX package's BurstActor (``env.act_burst`` on the Python plane) is not
ported: its purpose, one dispatch for many acting steps, is the captured
acting step's."""

from sheeprl_tpu_torch.envs.rollout.device_envs import CartPole, DeviceEnv, Pendulum, device_env_ids, make_device_env
from sheeprl_tpu_torch.envs.rollout.engine import RolloutEngine

__all__ = ["CartPole", "DeviceEnv", "Pendulum", "RolloutEngine", "device_env_ids", "make_device_env"]

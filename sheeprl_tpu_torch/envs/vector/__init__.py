"""The vector-env plane (counterpart of ``sheeprl_tpu/envs/vector``): one
factory for every entrypoint (:func:`make_vector_env`, :func:`make_eval_env`),
one seeding formula (:func:`env_seeds`), the serial
:class:`SyncVectorEnv` and the shared-memory fault-tolerant worker pool
:class:`AsyncSharedMemVectorEnv` behind ``env.vectorization=async``.
Importing the package loads no torch."""

from sheeprl_tpu_torch.envs.vector.async_env import AsyncSharedMemVectorEnv
from sheeprl_tpu_torch.envs.vector.factory import (
    env_seeds,
    make_eval_env,
    make_vector_env,
    resolve_backend,
    resolve_vectorization,
    vectorize_thunks,
)
from sheeprl_tpu_torch.envs.vector.shmem import N_SLOTS, SharedStepSlabs
from sheeprl_tpu_torch.envs.vector.sync_env import SyncVectorEnv

__all__ = [
    "AsyncSharedMemVectorEnv",
    "N_SLOTS",
    "SharedStepSlabs",
    "SyncVectorEnv",
    "env_seeds",
    "make_eval_env",
    "make_vector_env",
    "resolve_backend",
    "resolve_vectorization",
    "vectorize_thunks",
]


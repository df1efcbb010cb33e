"""Double-buffered shared-memory step slabs for the worker pool
(counterpart of ``sheeprl_tpu/envs/vector/shmem.py``).

One anonymous shared block (``multiprocessing.RawArray``, inherited by the
worker processes at start: nothing in /dev/shm to leak) per observation key,
and one each for reward, terminated and truncated, laid out as
``[n_slots, num_envs, *single_shape]`` with ``n_slots = 2``: the workers
write step *k* into slot ``k % 2`` while the arrays the caller received for
step *k − 1* (views of the other slot) stay valid. So ``obs`` of the previous
step and the current step's next observation never alias, and the one copy
on the path is the replay buffer's ``add``.

Observation spaces are :class:`~sheeprl_tpu_torch.envs.spaces.Dict`\\ s of
``Box``, ``Discrete`` or ``MultiDiscrete`` leaves, which is what
:func:`sheeprl_tpu_torch.utils.env.make_env` gives every configured env.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from sheeprl_tpu_torch.envs import spaces

__all__ = ["N_SLOTS", "SharedStepSlabs"]

#: two slots: the previous step's views survive the current step's writes
N_SLOTS = 2

_LEAVES = (spaces.Box, spaces.Discrete, spaces.MultiDiscrete)


def _leaf_spec(space) -> Tuple[Tuple[int, ...], np.dtype]:
    if not isinstance(space, _LEAVES):
        raise TypeError(
            f"AsyncSharedMemVectorEnv supports array-typed observation leaves, got {type(space).__name__}; "
            "use env.vectorization=sync for this env"
        )
    return tuple(space.shape), np.dtype(space.dtype)


def _alloc(ctx, shape: Tuple[int, ...], dtype: np.dtype):
    """One RawArray sized in bytes, viewed through ``np.frombuffer`` on each side."""
    return ctx.RawArray("b", max(int(np.prod(shape, dtype=np.int64)) * dtype.itemsize, 1))


def _view(raw, shape: Tuple[int, ...], dtype: np.dtype) -> np.ndarray:
    return np.frombuffer(raw, dtype=dtype, count=int(np.prod(shape, dtype=np.int64))).reshape(shape)


class SharedStepSlabs:
    """The step blocks shared between the parent and its workers; picklable
    (RawArrays and plain metadata), passed whole to each worker, which
    calls :meth:`views` once and indexes ``[slot, env]`` from then on."""

    def __init__(self, ctx, single_observation_space, num_envs: int):
        if not isinstance(single_observation_space, spaces.Dict):
            raise TypeError(
                "AsyncSharedMemVectorEnv requires a Dict observation space (make_env always gives one), got "
                f"{type(single_observation_space).__name__}"
            )
        self.num_envs = int(num_envs)
        self._specs: Dict[str, Tuple[Tuple[int, ...], np.dtype]] = {
            key: _leaf_spec(space) for key, space in single_observation_space.items()
        }
        self._obs_raw = {key: _alloc(ctx, (N_SLOTS, num_envs, *shape), dtype)
                         for key, (shape, dtype) in self._specs.items()}
        # float64 rewards and bool flags: the sync env's step arrays
        self._rew_raw = _alloc(ctx, (N_SLOTS, num_envs), np.dtype(np.float64))
        self._term_raw = _alloc(ctx, (N_SLOTS, num_envs), np.dtype(np.bool_))
        self._trunc_raw = _alloc(ctx, (N_SLOTS, num_envs), np.dtype(np.bool_))

    def views(self) -> Tuple[Dict[str, np.ndarray], np.ndarray, np.ndarray, np.ndarray]:
        """Numpy views of the blocks: ``(obs, rewards, terminated,
        truncated)``, each leading with ``[n_slots, num_envs]``."""
        n = self.num_envs
        obs = {key: _view(raw, (N_SLOTS, n, *self._specs[key][0]), self._specs[key][1])
               for key, raw in self._obs_raw.items()}
        return (obs, _view(self._rew_raw, (N_SLOTS, n), np.dtype(np.float64)),
                _view(self._term_raw, (N_SLOTS, n), np.dtype(np.bool_)),
                _view(self._trunc_raw, (N_SLOTS, n), np.dtype(np.bool_)))

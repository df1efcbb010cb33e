"""The vector env every entrypoint builds its envs through (counterpart of
``sheeprl_tpu/envs/vector/factory.py``).

:func:`make_vector_env` computes the canonical per-env seeds, builds the
wrapped env thunks (:func:`sheeprl_tpu_torch.utils.env.make_env`: each a
picklable ``partial`` of a module-level builder, so a worker process can
rebuild it) and picks the backend from ``env.vectorization``:

==============  ===========================================================
``sync``        (default) :class:`~.sync_env.SyncVectorEnv`, ``SAME_STEP``
                autoreset: serial, deterministic, no process.
``async``       :class:`~.async_env.AsyncSharedMemVectorEnv`: one worker
                process per env writing its step into shared memory, a
                per-step deadline, bounded worker restarts, degrade to sync.
``gym_async``   the same pool with restarts and the deadline off: a worker
                error raises, as gymnasium's ``AsyncVectorEnv`` does (the
                JAX package's backend; the card has no gymnasium).
==============  ===========================================================

The legacy ``env.sync_env`` keeps its meaning (``True`` → sync, ``False`` →
gym_async) while ``env.vectorization`` is unset. Worker processes start
with ``forkserver`` (``env.mp_context`` overrides it), never ``fork``: the
learner process holds a CUDA context. ``env.backend=jax`` selects the device
envs and the rollout engine (:mod:`sheeprl_tpu_torch.envs.rollout`) instead
of this plane; SAC branches on :func:`resolve_backend` before it builds
envs, and any other entrypoint that asks this factory for a ``jax`` backend
gets an error, as in the JAX package.
"""

from __future__ import annotations

import warnings
from functools import partial
from typing import Callable, List, Optional, Sequence

from sheeprl_tpu_torch.envs.wrappers import Env, RestartOnException
from sheeprl_tpu_torch.utils.env import make_env

__all__ = [
    "env_seeds",
    "make_eval_env",
    "make_vector_env",
    "resolve_backend",
    "resolve_vectorization",
    "vectorize_thunks",
]

_BACKENDS = ("sync", "async", "gym_async")
_ENV_BACKENDS = ("python", "jax")


def resolve_backend(cfg) -> str:
    """``env.backend``: ``python`` (this vector-env plane, the default) or
    ``jax`` (the device envs and the rollout engine, whose whole collection
    burst is one CUDA graph replay). The name stays the JAX package's: the
    config tree is shared."""
    backend = str(cfg.env.get("backend", "python") or "python").lower()
    if backend not in _ENV_BACKENDS:
        raise ValueError(f"env.backend must be one of {_ENV_BACKENDS}, got {backend!r}")
    return backend


def env_seeds(seed: int, rank: int, n_envs: int) -> List[int]:
    """Canonical per-env seeds: ``seed + rank * n_envs + idx`` (``rank`` the
    seed partition: a process, or a plane player with its ``n_envs``)."""
    return [int(seed) + int(rank) * int(n_envs) + idx for idx in range(int(n_envs))]


def resolve_vectorization(cfg) -> str:
    """An explicitly set ``env.vectorization`` wins (with a warning where
    the legacy ``env.sync_env`` says otherwise); else ``env.sync_env``
    (True → sync, False → gym_async); else sync."""
    mode = cfg.env.get("vectorization", None)
    legacy = cfg.env.get("sync_env", None)
    if mode is not None:
        mode = str(mode).lower()
        if mode not in _BACKENDS:
            raise ValueError(f"env.vectorization must be one of {_BACKENDS}, got {mode!r}")
        if legacy is not None and bool(legacy) != (mode == "sync"):
            warnings.warn(f"env.vectorization={mode} overrides legacy env.sync_env={bool(legacy)}")
        return mode
    if legacy is not None:
        return "sync" if legacy else "gym_async"
    return "sync"


def vectorize_thunks(thunks: Sequence[Callable[[], Env]], cfg, env_seeds_list: Optional[Sequence[int]] = None):
    """Wrap prebuilt thunks in the configured backend (the factory's lower
    half; the eval pool and the tests enter here). The worker pool needs
    thunks that pickle."""
    from sheeprl_tpu_torch.envs.vector.sync_env import SyncVectorEnv

    mode = resolve_vectorization(cfg)
    if mode == "sync":
        return SyncVectorEnv(thunks)
    from sheeprl_tpu_torch.envs.vector.async_env import AsyncSharedMemVectorEnv

    context = str(cfg.env.get("mp_context", "forkserver") or "forkserver")
    if mode == "gym_async":
        return AsyncSharedMemVectorEnv(thunks, env_seeds=env_seeds_list, context=context, worker_timeout_s=0.0,
                                       restart_workers=False)
    return AsyncSharedMemVectorEnv(
        thunks,
        env_seeds=env_seeds_list,
        context=context,
        worker_timeout_s=float(cfg.env.get("worker_timeout_s", 60.0) or 0.0),
        max_worker_restarts=int(cfg.env.get("max_worker_restarts", 3)),
        restart_window_s=float(cfg.env.get("restart_window_s", 300.0) or 0.0),
    )


def _check_backend(cfg) -> None:
    if resolve_backend(cfg) == "jax":
        raise NotImplementedError(
            "env.backend=jax: the device envs and the rollout engine (item 6d) drive SAC's training loop only, "
            "as in the JAX package; run this algorithm with env.backend=python"
        )


def make_vector_env(
    cfg,
    fabric=None,
    log_dir: Optional[str] = None,
    prefix: str = "train",
    restart_on_exception: bool = False,
    n_envs: Optional[int] = None,
    rank: Optional[int] = None,
):
    """The train-time vector env of one rank: ``env.num_envs`` envs seeded
    ``env_seeds(seed, rank, n_envs)`` (the JAX run's global env indices
    ``rank·n_envs + i``, for the seeds and the envs' own indices), each optionally behind
    :class:`RestartOnException`. ``rank`` overrides the seed partition
    (``fabric.global_rank``): a plane player passes its index with its own
    ``n_envs``, so N players slice the sequence one process would use."""
    _check_backend(cfg)
    if rank is None:
        rank = int(fabric.global_rank) if fabric is not None else 0
    rank = int(rank)
    if n_envs is None:
        n_envs = int(cfg.env.num_envs)
    seeds = env_seeds(cfg.seed, rank, n_envs)
    thunks = []
    for idx in range(n_envs):
        thunk = make_env(cfg, seeds[idx], 0, log_dir if rank == 0 else None, prefix, vector_env_idx=rank * n_envs + idx)
        if restart_on_exception:
            thunk = partial(RestartOnException, thunk)
        thunks.append(thunk)
    return vectorize_thunks(thunks, cfg, env_seeds_list=seeds)


def make_eval_env(cfg, log_dir: Optional[str], prefix: str = "test", rank: int = 0) -> Env:
    """One fully wrapped env for test episodes: the same wrappers and the
    same seed (env 0 of ``rank``) as the train-time factory."""
    seed = env_seeds(cfg.seed, rank, 1)[0]
    return make_env(cfg, seed, 0, log_dir, prefix, vector_env_idx=0)()

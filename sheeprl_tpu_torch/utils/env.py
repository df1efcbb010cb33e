"""Environment factory (counterpart of ``sheeprl_tpu/utils/env.py``).

Every env is normalized to a :class:`~sheeprl_tpu_torch.envs.spaces.Dict`
observation space whose image keys are uint8 CHW frames of
``env.screen_size`` (optionally grayscaled) and whose
vector keys pass through. Pipeline order, as in the JAX package: wrapper
target → ActionRepeat → MaskVelocity (``env.mask_velocities``) → dict-ification → resize/grayscale/CHW →
FrameStack → RewardAsObservation → seeding → TimeLimit →
RecordEpisodeStatistics.

The dummy envs need nothing but numpy. A gymnasium-backed wrapper target
(``env=atari``, ``env=gym``, ...) imports gymnasium when it is
instantiated and is adapted by
:class:`~sheeprl_tpu_torch.envs.wrappers.GymnasiumEnv`. A frame that must be
resized or grayscaled needs OpenCV (``cv2``), imported only then; without
it that step raises. ``env.frame_stack > 1`` stacks the image keys'
frames (:class:`~sheeprl_tpu_torch.envs.wrappers.FrameStack`, dilated by
``env.frame_stack_dilation``), as SAC-AE's preset asks. Video capture is
not ported.
"""

from __future__ import annotations

import warnings
from functools import partial
from typing import Any, Callable, Dict, Optional

import numpy as np

from sheeprl_tpu_torch.config.instantiate import instantiate
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.wrappers import (
    ActionRepeat,
    Env,
    FrameStack,
    GymnasiumEnv,
    MaskVelocityWrapper,
    RecordEpisodeStatistics,
    RewardAsObservationWrapper,
    TimeLimit,
    TransformObservation,
)

__all__ = ["build_env", "get_dummy_env", "make_env"]


def _dictify_observations(env: Env, cfg) -> Env:
    """A non-dict observation space becomes a one-key Dict: a 1-D Box under
    the first mlp key (default ``state``), a 2/3-D Box under the first cnn
    key (default ``rgb``)."""
    space = env.observation_space
    if isinstance(space, spaces.Dict):
        return env
    if not isinstance(space, spaces.Box):
        raise ValueError(f"Unsupported observation space: {type(space)}")
    if len(space.shape) < 2:
        keys, default, group = cfg.mlp_keys.encoder, "state", cfg.mlp_keys
    elif len(space.shape) <= 3:
        keys, default, group = cfg.cnn_keys.encoder, "rgb", cfg.cnn_keys
    else:
        raise ValueError(f"Unsupported Box observation rank: {space.shape}")
    if keys:
        if len(keys) > 1:
            warnings.warn(f"Multiple keys specified but {cfg.env.id} has a single observation; keeping {keys[0]}")
        key = keys[0]
    else:
        key = default
        group.encoder = [key]
    return TransformObservation(env, lambda obs, k=key: {k: obs}, spaces.Dict({key: space}))


def _cv2():
    try:
        import cv2
    except ImportError as exc:
        raise ImportError(
            "this env's frames must be resized or grayscaled, which needs OpenCV (cv2); it is not installed"
        ) from exc
    return cv2


def _image_transform(cfg, cnn_keys) -> Callable[[Dict[str, Any]], Dict[str, Any]]:
    """Per-step image normalization: resize → grayscale → uint8 CHW."""
    screen = cfg.env.screen_size
    grayscale = cfg.env.grayscale

    def transform(obs: Dict[str, Any]) -> Dict[str, Any]:
        for k in cnn_keys:
            frame = obs[k]
            is_3d = frame.ndim == 3
            is_gray = not is_3d or frame.shape[0] == 1 or frame.shape[-1] == 1
            channel_first = not is_3d or frame.shape[0] in (1, 3)
            if not is_3d:
                frame = frame[None]
            if channel_first:
                frame = np.transpose(frame, (1, 2, 0))
            if frame.shape[:-1] != (screen, screen):
                cv2 = _cv2()
                frame = cv2.resize(frame, (screen, screen), interpolation=cv2.INTER_AREA)
            if grayscale and not is_gray:
                cv2 = _cv2()
                frame = cv2.cvtColor(frame, cv2.COLOR_RGB2GRAY)
            if frame.ndim == 2:
                frame = frame[..., None]
                if not grayscale:
                    frame = np.repeat(frame, 3, axis=-1)
            obs[k] = np.transpose(frame, (2, 0, 1))
        return obs

    return transform


def build_env(
    cfg,
    seed: int,
    rank: int,
    run_name: Optional[str] = None,
    prefix: str = "",
    vector_env_idx: int = 0,
) -> Env:
    """Build one fully-wrapped env (the body of :func:`make_env`'s thunk)."""
    if cfg.env.capture_video and rank == 0 and vector_env_idx == 0 and run_name is not None:
        raise NotImplementedError(
            "env.capture_video=True: video capture is not ported: it needs moviepy, which the port's machines do "
            "not have (ROADMAP queue A); pass env.capture_video=False"
        )
    kwargs = {}
    if "seed" in cfg.env.wrapper:
        kwargs["seed"] = seed
    if "rank" in cfg.env.wrapper:
        kwargs["rank"] = rank + vector_env_idx
    env = instantiate(cfg.env.wrapper, **kwargs)
    if not isinstance(env, Env):
        env = GymnasiumEnv(env)

    # Atari-style envs repeat actions internally
    if cfg.env.action_repeat > 1 and "atari" not in str(cfg.env.wrapper.get("_target_", "")).lower():
        env = ActionRepeat(env, cfg.env.action_repeat)
    if cfg.env.get("mask_velocities", False):
        env = MaskVelocityWrapper(env)

    env = _dictify_observations(env, cfg)

    env_cnn_keys = {k for k, v in env.observation_space.items() if len(v.shape) in (2, 3)}
    cnn_keys = sorted(env_cnn_keys & set(cfg.cnn_keys.encoder or []))
    if cnn_keys:
        channels = 1 if cfg.env.grayscale else 3
        new_space = dict(env.observation_space.spaces)
        for k in cnn_keys:
            new_space[k] = spaces.Box(0, 255, (channels, cfg.env.screen_size, cfg.env.screen_size), np.uint8)
        env = TransformObservation(env, _image_transform(cfg, cnn_keys), spaces.Dict(new_space))
        if cfg.env.frame_stack > 1:
            if cfg.env.frame_stack_dilation <= 0:
                raise ValueError(
                    "The frame stack dilation argument must be greater than zero, "
                    f"got: {cfg.env.frame_stack_dilation}"
                )
            env = FrameStack(env, cfg.env.frame_stack, cnn_keys, cfg.env.frame_stack_dilation)

    if cfg.env.get("reward_as_observation", False):
        env = RewardAsObservationWrapper(env)

    env.action_space.seed(seed)
    env.observation_space.seed(seed)
    if cfg.env.max_episode_steps and cfg.env.max_episode_steps > 0:
        env = TimeLimit(env, max_episode_steps=cfg.env.max_episode_steps)
    return RecordEpisodeStatistics(env)


def make_env(
    cfg,
    seed: int,
    rank: int,
    run_name: Optional[str] = None,
    prefix: str = "",
    vector_env_idx: int = 0,
) -> Callable[[], Env]:
    """A thunk that builds one fully-wrapped env: a ``partial`` of the
    module-level :func:`build_env` over the config, the seed and the index,
    so that it pickles and a worker process of the vector env's pool can
    build the env itself."""
    return partial(build_env, cfg, seed, rank, run_name, prefix, vector_env_idx)


def get_dummy_env(id: str) -> Env:  # noqa: A002 — kwarg name fixed by env/dummy.yaml
    """The deterministic dummy envs the tests and dry runs use."""
    from sheeprl_tpu_torch.envs.dummy import ContinuousDummyEnv, DiscreteDummyEnv, MultiDiscreteDummyEnv

    if "continuous" in id:
        return ContinuousDummyEnv()
    if "multidiscrete" in id:
        return MultiDiscreteDummyEnv()
    if "discrete" in id:
        return DiscreteDummyEnv()
    raise ValueError(f"Unrecognized dummy environment: {id}")

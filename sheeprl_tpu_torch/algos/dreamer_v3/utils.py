"""Observation helpers (counterpart of ``prepare_obs`` and
``normalize_obs_jnp`` in ``sheeprl_tpu/algos/dreamer_v3/utils.py``)."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

__all__ = ["normalize_obs", "prepare_obs"]


def prepare_obs(
    obs: Dict[str, np.ndarray], cnn_keys: Sequence[str], mlp_keys: Sequence[str], n_envs: int
) -> Dict[str, np.ndarray]:
    """Host-side obs dict → arrays shaped for the models: cnn keys keep their
    dtype as ``[n, C, H, W]`` (frame stacks folded into C), mlp keys become
    float32 ``[n, -1]``."""
    out = {}
    for k in cnn_keys:
        v = np.asarray(obs[k])
        out[k] = v.reshape(n_envs, -1, *v.shape[-2:])
    for k in mlp_keys:
        out[k] = np.asarray(obs[k]).reshape(n_envs, -1).astype(np.float32)
    return out


def normalize_obs(
    obs: Dict[str, np.ndarray], cnn_keys: Sequence[str], device: torch.device
) -> Dict[str, torch.Tensor]:
    """Copy to ``device`` and scale uint8 pixels to [0, 1] there."""
    out = {}
    for k, v in obs.items():
        t = torch.as_tensor(np.ascontiguousarray(v)).to(device, non_blocking=True).float()
        out[k] = t / 255.0 if k in cnn_keys else t
    return out

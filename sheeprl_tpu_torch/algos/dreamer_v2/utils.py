"""Observation normalization (counterpart of ``normalize_obs_jnp`` in
``sheeprl_tpu/algos/dreamer_v2/utils.py``)."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

__all__ = ["normalize_obs"]


def normalize_obs(
    obs: Dict[str, np.ndarray], cnn_keys: Sequence[str], device: torch.device
) -> Dict[str, torch.Tensor]:
    """Copy to ``device`` and scale uint8 pixels to [-0.5, 0.5] there."""
    out = {}
    for k, v in obs.items():
        t = torch.as_tensor(np.ascontiguousarray(v)).to(device, non_blocking=True).float()
        out[k] = t / 255.0 - 0.5 if k in cnn_keys else t
    return out

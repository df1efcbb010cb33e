"""Run helpers (counterpart of ``gae``, ``normalize_tensor``,
``polynomial_decay``, ``print_config`` and ``save_configs`` in
``sheeprl_tpu/utils/utils.py``)."""

from __future__ import annotations

import os
from typing import TYPE_CHECKING, Tuple

from sheeprl_tpu_torch.config.yamlite import dump

if TYPE_CHECKING:  # the module loads no torch: the CLI imports it
    import torch

__all__ = ["gae", "normalize_tensor", "polynomial_decay", "print_config", "save_configs"]


def gae(
    rewards: torch.Tensor,
    values: torch.Tensor,
    dones: torch.Tensor,
    next_value: torch.Tensor,
    gamma: float,
    gae_lambda: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generalized advantage estimation over a rollout ``[T, ...]``, the JAX
    function's reversed scan in its order of operations: ``dones[t]`` ends
    transition t, so ``1 − dones[t]`` masks the bootstrap from t+1 (the next
    row's value, ``next_value`` after the last). Returns ``(returns,
    advantages)``, both ``[T, ...]``. No host synchronisation: the loop over
    T can be captured in a CUDA graph."""
    import torch

    dones = dones.to(rewards.dtype)
    next_value = next_value.to(rewards.dtype)
    next_values = torch.cat([values[1:], next_value[None]], dim=0)
    advantages = torch.empty_like(rewards)
    last = torch.zeros_like(next_value)
    for t in range(rewards.shape[0] - 1, -1, -1):
        nonterminal = 1.0 - dones[t]
        delta = rewards[t] + gamma * next_values[t] * nonterminal - values[t]
        last = delta + gamma * gae_lambda * nonterminal * last
        advantages[t] = last
    return advantages + values, advantages


def normalize_tensor(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """``(x − mean) / (std + eps)`` over every element, the std the
    population one (``jnp.std``'s ddof 0, not ``torch.std``'s default)."""
    return (x - x.mean()) / (x.std(correction=0) + eps)


def polynomial_decay(
    current_step: int,
    *,
    initial: float = 1.0,
    final: float = 0.0,
    max_decay_steps: int = 100,
    power: float = 1.0,
) -> float:
    """Polynomial annealing from ``initial`` to ``final`` over ``max_decay_steps``."""
    if current_step > max_decay_steps or initial == final:
        return final
    return (initial - final) * ((1 - current_step / max_decay_steps) ** power) + final


def _plain(cfg):
    return cfg.as_dict() if hasattr(cfg, "as_dict") else dict(cfg)


def print_config(cfg, logger=print) -> None:
    """Print the run config as YAML, one top-level section at a time."""
    logger("CONFIG")
    for key, value in _plain(cfg).items():
        body = dump({key: value}).rstrip("\n")
        logger(body)


def save_configs(cfg, log_dir: str) -> None:
    """Write the composed config to ``<log_dir>/.hydra/config.yaml``, the file
    resume and serving read back (the JAX package's layout)."""
    os.makedirs(os.path.join(log_dir, ".hydra"), exist_ok=True)
    with open(os.path.join(log_dir, ".hydra", "config.yaml"), "w") as f:
        f.write(dump(_plain(cfg)))

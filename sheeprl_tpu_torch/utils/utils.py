"""Run helpers (counterpart of ``polynomial_decay``, ``print_config`` and
``save_configs`` in ``sheeprl_tpu/utils/utils.py``)."""

from __future__ import annotations

import os

from sheeprl_tpu_torch.config.yamlite import dump

__all__ = ["polynomial_decay", "print_config", "save_configs"]


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

"""TensorBoard logging and the run directory (counterpart of
``sheeprl_tpu/utils/logger.py``).

The JAX package writes through tensorboardX's ``SummaryWriter``; the port
writes the same events with its own writer (:mod:`.tb_events`), and dumps
the hyperparameters with its own YAML writer instead of
``yaml.safe_dump``. The run telemetry that the JAX
``create_tensorboard_logger`` attaches to the run directory is not ported
(ROADMAP queue A item 6h)."""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

from sheeprl_tpu_torch.config.yamlite import dump
from sheeprl_tpu_torch.utils.tb_events import EventFileWriter

__all__ = ["TensorBoardLogger", "create_tensorboard_logger", "get_log_dir"]


class TensorBoardLogger:
    """The log calls the training loops make, into one event file in ``log_dir``."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._writer = EventFileWriter(log_dir)

    @property
    def path(self) -> str:
        """The event file."""
        return self._writer.path

    def log_metrics(self, metrics: Dict[str, Any], step: int) -> None:
        for name, value in metrics.items():
            if value is None:
                continue
            self._writer.add_scalar(name, float(value), step)

    def log_hyperparams(self, params: Dict[str, Any]) -> None:
        self._writer.add_text("hparams", f"```yaml\n{dump(params)}\n```")

    def flush(self) -> None:
        self._writer.flush()

    def close(self) -> None:
        self._writer.close()


def _next_version(parent: str) -> int:
    if not os.path.isdir(parent):
        return 0
    versions = [
        int(d.split("_")[1]) for d in os.listdir(parent) if d.startswith("version_") and d.split("_")[1].isdigit()
    ]
    return max(versions) + 1 if versions else 0


def get_log_dir(cfg) -> str:
    """Create and return ``logs/runs/<root_dir>/<run_name>/version_<k>``
    (an absolute ``root_dir`` places the run there), ``k`` one past the
    newest existing version."""
    root_dir = cfg.root_dir if cfg.root_dir is not None else "default"
    base = os.path.join("logs", "runs", str(root_dir), str(cfg.run_name))
    log_dir = os.path.join(base, f"version_{_next_version(base)}")
    os.makedirs(log_dir, exist_ok=True)
    return log_dir


def create_tensorboard_logger(cfg) -> Tuple[Optional[TensorBoardLogger], str]:
    """``(logger, log_dir)``: the logger is None at ``metric.log_level=0``."""
    log_dir = get_log_dir(cfg)
    logger = TensorBoardLogger(log_dir) if int(cfg.metric.log_level) > 0 else None
    return logger, log_dir

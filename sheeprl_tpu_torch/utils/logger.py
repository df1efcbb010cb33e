"""TensorBoard logging and the run directory (counterpart of
``sheeprl_tpu/utils/logger.py``).

The JAX package writes through tensorboardX's ``SummaryWriter``; the port
writes the same events with its own writer (:mod:`.tb_events`), and dumps
the hyperparameters with its own YAML writer instead of
``yaml.safe_dump``. Every loop resolves its run directory here, so this is
where the run telemetry learns where its trace, live snapshot and
``telemetry.json`` belong."""

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
    newest existing version. In a data-parallel world rank 0 picks and
    creates it and broadcasts the path, so that every rank agrees (the
    reference's rank-0 broadcast)."""
    import numpy as np

    from sheeprl_tpu_torch.obs.dist import comms
    from sheeprl_tpu_torch.parallel import current_world

    root_dir = cfg.root_dir if cfg.root_dir is not None else "default"
    base = os.path.join("logs", "runs", str(root_dir), str(cfg.run_name))
    world = current_world()
    if world is None or world.global_rank == 0:
        log_dir = os.path.join(base, f"version_{_next_version(base)}")
        os.makedirs(log_dir, exist_ok=True)
    else:
        log_dir = ""
    if world is not None:
        buf = np.zeros(4096, np.uint8)
        encoded = log_dir.encode()
        buf[: len(encoded)] = np.frombuffer(encoded, np.uint8)
        log_dir = bytes(comms.host_broadcast(buf, src=0)).rstrip(b"\0").decode()
    return log_dir


def create_tensorboard_logger(cfg) -> Tuple[Optional[TensorBoardLogger], str]:
    """``(logger, log_dir)``: the logger is None at ``metric.log_level=0``
    and on every rank but rank 0 of a data-parallel world (only rank 0
    writes events), which shares rank 0's ``log_dir``."""
    from sheeprl_tpu_torch.obs.telemetry import get_telemetry
    from sheeprl_tpu_torch.parallel import current_world

    log_dir = get_log_dir(cfg)
    world = current_world()
    rank0 = world is None or world.global_rank == 0
    logger = TensorBoardLogger(log_dir) if int(cfg.metric.log_level) > 0 and rank0 else None
    telemetry = get_telemetry()
    if telemetry is not None:
        telemetry.attach_run_dir(log_dir)
    return logger, log_dir

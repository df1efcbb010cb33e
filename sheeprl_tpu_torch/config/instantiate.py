"""``_target_``-style object instantiation (counterpart of
``sheeprl_tpu/config/instantiate.py``, hydra.utils.instantiate parity).

Reference config trees (``sheeprl.*``, ``torchmetrics.*``, ``lightning.*``)
resolve to the port's classes through the alias table. A target in the
port's namespace whose module or class is not ported yet raises
``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import importlib
from functools import partial
from typing import Any, Dict

__all__ = ["instantiate", "resolve_target"]

# reference class path -> port class path
TARGET_ALIASES: Dict[str, str] = {
    "lightning.fabric.Fabric": "sheeprl_tpu_torch.fabric.Fabric",
    "sheeprl.utils.callback.CheckpointCallback": "sheeprl_tpu_torch.utils.callback.CheckpointCallback",
    "sheeprl.utils.metric.MetricAggregator": "sheeprl_tpu_torch.utils.metric.MetricAggregator",
    "torchmetrics.MeanMetric": "sheeprl_tpu_torch.utils.metric.MeanMetric",
    "torchmetrics.SumMetric": "sheeprl_tpu_torch.utils.metric.SumMetric",
    "gym.make": "gymnasium.make",
}
# any other `sheeprl.` path maps onto the same path in the port
_PREFIX_ALIASES = {"sheeprl.": "sheeprl_tpu_torch."}
_PORT = "sheeprl_tpu_torch."
# targets of the YAML tree that the port does not have yet → the ROADMAP item that ports them
NOT_PORTED: Dict[str, str] = {
    "sheeprl_tpu_torch.envs.crafter": "ROADMAP queue A item 6i (real-simulator env wrappers)",
    "sheeprl_tpu_torch.envs.diambra": "ROADMAP queue A item 6i (real-simulator env wrappers)",
    "sheeprl_tpu_torch.envs.minedojo": "ROADMAP queue A item 6i (real-simulator env wrappers)",
    "sheeprl_tpu_torch.envs.minerl": "ROADMAP queue A item 6i (real-simulator env wrappers)",
    "sheeprl_tpu_torch.utils.optim.AdamW": "ROADMAP queue A item 5 (the families that configure it)",
    "sheeprl_tpu_torch.utils.optim.SGD": "ROADMAP queue A item 5 (the families that configure it)",
}


def _not_ported(path: str) -> str:
    for prefix, item in NOT_PORTED.items():
        if path == prefix or path.startswith(prefix + "."):
            return item
    return "see ROADMAP queue A"


def resolve_target(path: str) -> Any:
    path = TARGET_ALIASES.get(path, path)
    for old, new in _PREFIX_ALIASES.items():
        if path.startswith(old):
            path = new + path[len(old):]
            break
    module_name, _, attr = path.rpartition(".")
    if not module_name:
        raise ValueError(f"Cannot resolve target '{path}'")
    ported = not path.startswith(_PORT) or not any(
        path == p or path.startswith(p + ".") for p in NOT_PORTED
    )
    try:
        if not ported:
            raise LookupError(path)
        return getattr(importlib.import_module(module_name), attr)
    except (LookupError, ModuleNotFoundError, AttributeError) as exc:
        if path.startswith(_PORT):
            raise NotImplementedError(f"target {path} is not ported yet: {_not_ported(path)}") from exc
        raise


def instantiate(cfg: Any, *args: Any, **kwargs: Any) -> Any:
    """Build the object described by ``cfg['_target_']``.

    Remaining keys become keyword arguments (nested ``_target_`` dicts are
    instantiated recursively). ``_partial_: true`` returns a functools.partial.
    """
    if cfg is None:
        return None
    if isinstance(cfg, (list, tuple)):
        return [instantiate(c) for c in cfg]
    if not isinstance(cfg, dict):
        raise TypeError(f"instantiate expects a dict with _target_, got {type(cfg)}")
    cfg = dict(cfg)
    target = cfg.pop("_target_", None)
    if target is None:
        raise ValueError(f"Missing _target_ in config: {cfg}")
    is_partial = bool(cfg.pop("_partial_", False))
    cfg.pop("_convert_", None)
    fn = resolve_target(target)

    def convert(v):
        # hydra's _recursive_=True default: instantiate _target_ dicts found
        # anywhere inside plain containers too (metrics dicts, callback lists)
        if isinstance(v, dict):
            if "_target_" in v:
                return instantiate(v)
            return {k: convert(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [convert(x) for x in v]
        return v

    final_kwargs = {k: convert(v) for k, v in cfg.items()}
    final_kwargs.update(kwargs)
    if is_partial:
        return partial(fn, *args, **final_kwargs)
    return fn(*args, **final_kwargs)

"""DroQ evaluation entrypoint (counterpart of
``sheeprl_tpu/algos/droq/evaluate.py``): the actor is SAC's, so SAC's
eval-policy builder, registered for ``droq`` in ``algos/sac/evaluate.py``,
serves it."""

from __future__ import annotations

from typing import Any, Dict

from sheeprl_tpu_torch.evals.service import run_eval_entrypoint
from sheeprl_tpu_torch.utils.registry import register_evaluation

__all__ = ["evaluate_droq"]


@register_evaluation(algorithms=["droq"])
def evaluate_droq(fabric, cfg: Dict[str, Any], state: Dict[str, Any]):
    return run_eval_entrypoint(fabric, cfg, state)

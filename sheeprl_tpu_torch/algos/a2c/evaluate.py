"""A2C evaluation (counterpart of ``sheeprl_tpu/algos/a2c/evaluate.py``):
the agent is PPO's, so PPO's builder (registered for ``a2c`` in
``algos/ppo/evaluate.py``) serves it through the shared service."""

from __future__ import annotations

from typing import Any, Dict

from sheeprl_tpu_torch.algos.ppo import evaluate as _ppo_evaluate  # noqa: F401  (registers the builder)
from sheeprl_tpu_torch.evals.service import run_eval_entrypoint
from sheeprl_tpu_torch.utils.registry import register_evaluation

__all__ = ["evaluate_a2c"]


@register_evaluation(algorithms=["a2c"])
def evaluate_a2c(fabric, cfg: Dict[str, Any], state: Dict[str, Any]):
    return run_eval_entrypoint(fabric, cfg, state)

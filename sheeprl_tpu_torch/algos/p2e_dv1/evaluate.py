"""P2E-DV1 evaluation (counterpart of ``sheeprl_tpu/algos/p2e_dv1/evaluate.py``):
the eval-policy builder and the evaluation entrypoint, registered for both
phases. Both evaluate the task actor (an exploration checkpoint's
``actor_task``, a finetuning checkpoint's ``actor``; the port's layout or
the JAX package's) with DreamerV1's player: the actor's mode."""

from __future__ import annotations

from typing import Any, Dict

from sheeprl_tpu_torch.algos.dreamer_v1.evaluate import dreamer_v1_eval_builder
from sheeprl_tpu_torch.evals.service import EvalPolicy, register_eval_builder, run_eval_entrypoint
from sheeprl_tpu_torch.utils.registry import register_evaluation

__all__ = ["evaluate_p2e_dv1", "p2e_dv1_eval_builder"]

PHASES = ["p2e_dv1_exploration", "p2e_dv1_finetuning"]


@register_eval_builder(algorithms=PHASES)
def p2e_dv1_eval_builder(
    fabric, cfg, state, observation_space, action_space, device=None, plain_cell: bool = False
) -> EvalPolicy:
    """DreamerV1's builder over the checkpoint's task actor
    (``evals.builders.serving_params`` picks it)."""
    return dreamer_v1_eval_builder(fabric, cfg, state, observation_space, action_space, device, plain_cell)


@register_evaluation(algorithms=PHASES)
def evaluate_p2e_dv1(fabric, cfg: Dict[str, Any], state: Dict[str, Any]):
    return run_eval_entrypoint(fabric, cfg, state)

"""Recurrent-PPO evaluation (counterpart of
``sheeprl_tpu/algos/ppo_recurrent/evaluate.py``): the eval-policy builder,
used by the eval service, the serving gateway (which keeps each client's
rows of state and resets them at ``is_first``) and the in-run evaluator,
and the evaluation entrypoint of ``cli.evaluation``. The policy state is
the LSTM's ``c`` and ``h``, the previous actions (one-hot) and the
``is_first`` flag, each with the rows on axis 0 (``init_state(n)``: zeros,
``is_first`` ones), so the service's generic reset of finished rows
applies."""

from __future__ import annotations

from typing import Any, Dict

import torch

from sheeprl_tpu_torch.algos.ppo.evaluate import check_spaces, params_of
from sheeprl_tpu_torch.algos.ppo_recurrent.agent import build_agent
from sheeprl_tpu_torch.algos.ppo_recurrent.utils import recurrent_greedy
from sheeprl_tpu_torch.evals.builders import actions_dim_of
from sheeprl_tpu_torch.evals.service import EvalPolicy, register_eval_builder, run_eval_entrypoint
from sheeprl_tpu_torch.utils.registry import register_evaluation

__all__ = ["evaluate_ppo_recurrent", "ppo_recurrent_eval_builder"]


@register_eval_builder(algorithms=["ppo_recurrent"])
def ppo_recurrent_eval_builder(fabric, cfg, state, observation_space, action_space, device=None,
                               plain_cell: bool = False) -> EvalPolicy:
    """The greedy recurrent agent over the checkpoint's weights (its LSTM is
    PyTorch operations: ``plain_cell`` is unused)."""
    del plain_cell
    check_spaces(cfg, observation_space)
    if device is None:
        device = fabric.device if fabric is not None else "cuda"
    device = torch.device(device)
    actions_dim, is_continuous = actions_dim_of(action_space)
    cnn_keys, mlp_keys = list(cfg.cnn_keys.encoder), list(cfg.mlp_keys.encoder)
    agent = build_agent(cfg, actions_dim, is_continuous, cnn_keys, mlp_keys, observation_space)
    agent.load_state_dict(params_of(state, "ppo_recurrent"))
    agent = agent.to(device).eval()
    steps = {}

    def act(obs, policy_state, generator):
        n = int(next(iter(obs.values())).shape[0])
        if n not in steps:
            steps[n] = recurrent_greedy(agent, cnn_keys, mlp_keys, n, device)
        return steps[n](obs, policy_state)

    return EvalPolicy(act=act, init_state=recurrent_greedy(agent, cnn_keys, mlp_keys, 1, device).init_state,
                      device=device)


@register_evaluation(algorithms=["ppo_recurrent"])
def evaluate_ppo_recurrent(fabric, cfg: Dict[str, Any], state: Dict[str, Any]):
    return run_eval_entrypoint(fabric, cfg, state)

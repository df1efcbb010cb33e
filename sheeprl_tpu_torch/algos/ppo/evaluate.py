"""PPO evaluation (counterpart of ``sheeprl_tpu/algos/ppo/evaluate.py``):
the eval-policy builder, registered for ``ppo``, ``ppo_decoupled`` and
``a2c`` (they train the same agent with the same checkpoint layout) and used by the eval service,
the serving gateway and the in-run evaluator, and the evaluation
entrypoint of ``cli.evaluation``. The policy is greedy: each discrete
head's argmax, or the Gaussian's mean."""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from sheeprl_tpu_torch.algos.ppo.agent import build_agent, greedy_actions
from sheeprl_tpu_torch.algos.ppo.utils import normalize_obs, prepare_obs
from sheeprl_tpu_torch.algos.sac.evaluate import is_jax_tree
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.evals.builders import actions_dim_of
from sheeprl_tpu_torch.evals.service import EvalPolicy, register_eval_builder, run_eval_entrypoint
from sheeprl_tpu_torch.utils.registry import register_evaluation

__all__ = ["check_spaces", "evaluate_ppo", "evaluate_ppo_decoupled", "params_of", "ppo_eval_builder"]


def check_spaces(cfg, observation_space) -> None:
    if not isinstance(observation_space, spaces.Dict):
        raise RuntimeError(f"Unexpected observation type, should be of type Dict, got: {observation_space}")
    if len(cfg.cnn_keys.encoder) + len(cfg.mlp_keys.encoder) == 0:
        raise RuntimeError(
            "You should specify at least one CNN keys or MLP keys from the cli: "
            "`cnn_keys.encoder=[rgb]` or `mlp_keys.encoder=[state]`"
        )


def params_of(state: Mapping[str, Any], algo: str) -> Dict[str, torch.Tensor]:
    """The agent's ``state_dict`` from a checkpoint's or a publication's
    ``state`` (a decoupled run's plane publishes the agent's tree itself):
    the port's ``params``, or the JAX package's flax tree converted."""
    params = state["params"] if "params" in state else state
    if not is_jax_tree(params):
        return {k: torch.as_tensor(np.asarray(v)) for k, v in params.items()}
    from sheeprl_tpu_torch.convert import onpolicy_converter

    return onpolicy_converter(algo)(params)


@register_eval_builder(algorithms=["ppo", "ppo_decoupled", "a2c"])
def ppo_eval_builder(fabric, cfg, state, observation_space, action_space, device=None,
                     plain_cell: bool = False) -> EvalPolicy:
    """The greedy PPO (or A2C) agent over the checkpoint's weights (no
    recurrent cell: ``plain_cell`` is unused)."""
    del plain_cell
    check_spaces(cfg, observation_space)
    if device is None:
        device = fabric.device if fabric is not None else "cuda"
    device = torch.device(device)
    actions_dim, is_continuous = actions_dim_of(action_space)
    cnn_keys, mlp_keys = list(cfg.cnn_keys.encoder), list(cfg.mlp_keys.encoder)
    obs_keys = mlp_keys + cnn_keys
    agent = build_agent(cfg, actions_dim, is_continuous, cnn_keys, mlp_keys, observation_space)
    agent.load_state_dict(params_of(state, str(cfg.algo.name)))
    agent = agent.to(device).eval()

    @torch.no_grad()
    def act(obs, policy_state, generator):
        n = int(np.asarray(next(iter(obs.values()))).shape[0])
        prepared = prepare_obs({k: obs[k] for k in obs_keys}, cnn_keys, n)
        norm = normalize_obs({k: torch.from_numpy(v).to(device) for k, v in prepared.items()}, cnn_keys, obs_keys)
        return greedy_actions(agent.pre_dist(norm), is_continuous).cpu().numpy(), policy_state

    return EvalPolicy(act=act, device=device)


@register_evaluation(algorithms=["ppo"])
def evaluate_ppo(fabric, cfg: Dict[str, Any], state: Dict[str, Any]):
    return run_eval_entrypoint(fabric, cfg, state)


@register_evaluation(algorithms=["ppo_decoupled"])
def evaluate_ppo_decoupled(fabric, cfg: Dict[str, Any], state: Dict[str, Any]):
    return run_eval_entrypoint(fabric, cfg, state)

"""SAC-AE evaluation (counterpart of ``sheeprl_tpu/algos/sac_ae/evaluate.py``):
the eval-policy builder (the encoder and the actor rebuilt from the run's
config, the greedy tanh action on a batch) and the evaluation entrypoint."""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from sheeprl_tpu_torch.algos.sac.agent import action_bounds, greedy_action
from sheeprl_tpu_torch.algos.sac.evaluate import check_spaces, is_jax_tree
from sheeprl_tpu_torch.algos.sac_ae.agent import build_agent
from sheeprl_tpu_torch.algos.sac_ae.utils import normalize_obs, prepare_obs
from sheeprl_tpu_torch.evals.service import EvalPolicy, register_eval_builder, run_eval_entrypoint
from sheeprl_tpu_torch.utils.registry import register_evaluation

__all__ = ["evaluate_sac_ae", "sac_ae_eval_builder", "sac_ae_eval_policy", "serving_modules"]


def serving_modules(state: Mapping[str, Any]) -> Dict[str, Mapping[str, Any]]:
    """``{"encoder", "actor"}`` state dicts from a checkpoint's or a
    publication's ``state``, in the port's layout or the JAX package's."""
    agent = state["agent"]
    if not is_jax_tree(agent["actor"]):
        return {k: agent[k] for k in ("encoder", "actor")}
    from sheeprl_tpu_torch.convert import convert_sac_ae

    return convert_sac_ae({k: agent[k] for k in ("encoder", "actor")})[0]


def sac_ae_eval_policy(cfg, params: Mapping[str, Mapping[str, Any]], observation_space, action_space,
                       device) -> EvalPolicy:
    """The greedy action ``tanh(mean)·scale + bias`` of the actor over the
    encoder's features of the prepared observation."""
    check_spaces(observation_space, action_space, "SAC-AE")
    device = torch.device(device)
    modules = build_agent(cfg, int(np.prod(action_space.shape)), observation_space, None, training=False)
    for name, module in modules.items():
        module.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in params[name].items()})
        module.to(device).eval()
    encoder, actor = modules["encoder"], modules["actor"]
    scale, bias = (torch.as_tensor(b).to(device) for b in action_bounds(action_space))
    cnn_keys, mlp_keys = list(cfg.cnn_keys.encoder), list(cfg.mlp_keys.encoder)

    @torch.no_grad()
    def act(obs, policy_state, generator):
        n = int(np.asarray(next(iter(obs.values()))).shape[0])
        mean, _ = actor(encoder(normalize_obs(prepare_obs(obs, cnn_keys, mlp_keys, n), cnn_keys, device)))
        return greedy_action(mean, scale, bias).cpu().numpy(), policy_state

    return EvalPolicy(act=act, device=device)


@register_eval_builder(algorithms=["sac_ae"])
def sac_ae_eval_builder(fabric, cfg, state, observation_space, action_space, device=None,
                        plain_cell: bool = False) -> EvalPolicy:
    """The registered builder (no recurrent cell: ``plain_cell`` is unused)."""
    del plain_cell
    if device is None:
        device = fabric.device if fabric is not None else "cuda"
    return sac_ae_eval_policy(cfg, serving_modules(state), observation_space, action_space, device)


@register_evaluation(algorithms=["sac_ae"])
def evaluate_sac_ae(fabric, cfg: Dict[str, Any], state: Dict[str, Any]):
    return run_eval_entrypoint(fabric, cfg, state)

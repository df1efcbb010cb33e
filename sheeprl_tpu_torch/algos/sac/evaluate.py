"""SAC evaluation (counterpart of ``sheeprl_tpu/algos/sac/evaluate.py``):
the eval-policy builder, registered for ``sac``, ``sac_decoupled`` and
``droq`` (they train the same actor with the same checkpoint layout) and
used by the eval service, the serving gateway and the in-run evaluator, and
the evaluation entrypoints of ``cli.evaluation``."""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from sheeprl_tpu_torch.algos.sac.agent import SACActor, action_bounds, greedy_action
from sheeprl_tpu_torch.algos.sac.utils import concat_obs
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.evals.service import EvalPolicy, register_eval_builder, run_eval_entrypoint
from sheeprl_tpu_torch.utils.registry import register_evaluation

__all__ = ["evaluate_sac", "evaluate_sac_decoupled", "is_jax_tree", "sac_eval_builder", "sac_eval_policy"]


def is_jax_tree(tree: Mapping[str, Any]) -> bool:
    """A flax param tree (nested dicts) rather than a ``state_dict`` (flat keys)."""
    return any(isinstance(v, Mapping) for v in tree.values())


def check_spaces(observation_space, action_space, family: str) -> None:
    if not isinstance(action_space, spaces.Box):
        raise ValueError(f"Only continuous action space is supported for the {family} agent")
    if not isinstance(observation_space, spaces.Dict):
        raise RuntimeError(f"Unexpected observation type, should be of type Dict, got: {observation_space}")


def sac_eval_policy(cfg, actor_params: Mapping[str, Any], observation_space, action_space, device) -> EvalPolicy:
    """The greedy SAC actor ``tanh(mean)·scale + bias`` over the MLP keys,
    from the actor's ``state_dict``."""
    check_spaces(observation_space, action_space, "SAC")
    mlp_keys = list(cfg.mlp_keys.encoder)
    if len(mlp_keys) == 0:
        raise RuntimeError("You should specify at least one MLP key for the encoder: `mlp_keys.encoder=[state]`")
    device = torch.device(device)
    act_dim = int(np.prod(action_space.shape))
    obs_dim = int(sum(np.prod(observation_space[k].shape) for k in mlp_keys))
    actor = SACActor(obs_dim, act_dim, int(cfg.algo.actor.hidden_size))
    actor.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in actor_params.items()})
    actor = actor.to(device).eval()
    scale, bias = (torch.as_tensor(b).to(device) for b in action_bounds(action_space))

    @torch.no_grad()
    def act(obs, policy_state, generator):
        n = int(np.asarray(next(iter(obs.values()))).shape[0])
        x = torch.as_tensor(concat_obs(obs, mlp_keys, n)).to(device)
        mean, _ = actor(x)
        return greedy_action(mean, scale, bias).cpu().numpy(), policy_state

    return EvalPolicy(act=act, device=device)


def actor_params_of(state: Mapping[str, Any]) -> Mapping[str, Any]:
    """The actor's ``state_dict`` from a checkpoint's or a publication's
    ``state`` (a decoupled run's plane publishes the actor's tree itself):
    the port's layout, or the JAX package's flax tree converted."""
    actor = state["agent"]["actor"] if "agent" in state else state
    if not is_jax_tree(actor):
        return actor
    from sheeprl_tpu_torch.convert import convert_sac_actor

    return convert_sac_actor(actor)


@register_eval_builder(algorithms=["sac", "sac_decoupled", "droq"])
def sac_eval_builder(fabric, cfg, state, observation_space, action_space, device=None,
                     plain_cell: bool = False) -> EvalPolicy:
    """The registered builder (no recurrent cell: ``plain_cell`` is unused)."""
    del plain_cell
    if device is None:
        device = fabric.device if fabric is not None else "cuda"
    return sac_eval_policy(cfg, actor_params_of(state), observation_space, action_space, device)


@register_evaluation(algorithms=["sac"])
def evaluate_sac(fabric, cfg: Dict[str, Any], state: Dict[str, Any]):
    return run_eval_entrypoint(fabric, cfg, state)


@register_evaluation(algorithms=["sac_decoupled"])
def evaluate_sac_decoupled(fabric, cfg: Dict[str, Any], state: Dict[str, Any]):
    return run_eval_entrypoint(fabric, cfg, state)

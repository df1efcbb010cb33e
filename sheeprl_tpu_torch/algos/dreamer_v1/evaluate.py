"""DreamerV1 evaluation (counterpart of
``sheeprl_tpu/algos/dreamer_v1/evaluate.py``): the eval-policy builder,
registered for the eval service, the serving gateway and the in-run
evaluator, and the evaluation entrypoint of ``cli.evaluation``."""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence

from sheeprl_tpu_torch.algos.dreamer_v1.agent import build_agent, build_player_fns
from sheeprl_tpu_torch.algos.dreamer_v1.utils import normalize_obs
from sheeprl_tpu_torch.evals.builders import actions_dim_of, dreamer_eval_policy, serving_params
from sheeprl_tpu_torch.evals.service import EvalPolicy, register_eval_builder, run_eval_entrypoint
from sheeprl_tpu_torch.utils.registry import register_evaluation

__all__ = ["dreamer_v1_eval_builder", "dreamer_v1_eval_policy", "evaluate_dreamer_v1"]


def dreamer_v1_eval_policy(
    cfg,
    params: Dict[str, Mapping[str, Any]],
    observation_space: Mapping[str, Any],
    actions_dim: Sequence[int],
    is_continuous: bool,
    device=None,
    plain_cell: bool = False,
) -> EvalPolicy:
    """Greedy DV1 policy from ``params = {"world_model": state_dict, "actor":
    state_dict}`` (the port's own layout; ``convert.py`` makes it from the
    JAX trees). DreamerV1's recurrent cell has no kernel: it is the plain
    PyTorch version with or without ``plain_cell``."""
    del plain_cell
    if len(cfg.cnn_keys.encoder) + len(cfg.mlp_keys.encoder) == 0:
        raise RuntimeError(
            "You should specify at least one CNN keys or MLP keys from the cli: "
            "`cnn_keys.encoder=[rgb]` or `mlp_keys.encoder=[state]`"
        )
    world_model, actor = build_agent(cfg, actions_dim, is_continuous, observation_space, device=device)
    world_model.load_state_dict(params["world_model"])
    actor.load_state_dict(params["actor"])
    player_fns = build_player_fns(world_model, actor, cfg, actions_dim, is_continuous)
    device = next(world_model.parameters()).device
    return dreamer_eval_policy(player_fns, cfg, is_continuous, device, normalize_fn=normalize_obs)


@register_eval_builder(algorithms=["dreamer_v1"])
def dreamer_v1_eval_builder(
    fabric, cfg, state, observation_space, action_space, device=None, plain_cell: bool = False
) -> EvalPolicy:
    """The registered builder: a checkpoint's or a publication's ``state``
    (the port's layout or the JAX package's) → the policy on ``device``
    (``fabric.device`` when None)."""
    if device is None:
        device = fabric.device if fabric is not None else None
    actions_dim, is_continuous = actions_dim_of(action_space)
    return dreamer_v1_eval_policy(
        cfg,
        serving_params(state, str(cfg.algo.name)),
        observation_space.spaces,
        actions_dim,
        is_continuous,
        device=device,
        plain_cell=plain_cell,
    )


@register_evaluation(algorithms=["dreamer_v1"])
def evaluate_dreamer_v1(fabric, cfg: Dict[str, Any], state: Dict[str, Any]):
    return run_eval_entrypoint(fabric, cfg, state)

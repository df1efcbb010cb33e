"""DreamerV2 eval-policy builder (counterpart of ``dreamer_v2_eval_policy`` in
``sheeprl_tpu/algos/dreamer_v2/evaluate.py``)."""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence

from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_agent, build_player_fns, set_cell_impl
from sheeprl_tpu_torch.algos.dreamer_v2.utils import normalize_obs
from sheeprl_tpu_torch.evals.builders import dreamer_eval_policy
from sheeprl_tpu_torch.evals.service import EvalPolicy

__all__ = ["dreamer_v2_eval_policy"]


def dreamer_v2_eval_policy(
    cfg,
    params: Dict[str, Mapping[str, Any]],
    observation_space: Mapping[str, Any],
    actions_dim: Sequence[int],
    is_continuous: bool,
    device=None,
    plain_cell: bool = False,
) -> EvalPolicy:
    """Greedy DV2 policy from ``params = {"world_model": state_dict, "actor":
    state_dict}`` (the port's own layout; ``convert.py`` makes it from the
    JAX trees). ``plain_cell=True`` runs the recurrent cell's plain version,
    for holding the CUDA kernel against it."""
    if len(cfg.cnn_keys.encoder) + len(cfg.mlp_keys.encoder) == 0:
        raise RuntimeError("DreamerV2 needs at least one cnn or mlp encoder key")
    world_model, actor = build_agent(cfg, actions_dim, is_continuous, observation_space, device=device)
    world_model.load_state_dict(params["world_model"])
    actor.load_state_dict(params["actor"])
    if plain_cell:
        set_cell_impl(world_model, "plain")
    player_fns = build_player_fns(world_model, actor, cfg, actions_dim, is_continuous)
    device = next(world_model.parameters()).device
    return dreamer_eval_policy(player_fns, cfg, is_continuous, device, normalize_fn=normalize_obs)

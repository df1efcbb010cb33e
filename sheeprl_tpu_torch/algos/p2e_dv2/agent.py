"""Plan2Explore on DreamerV2: the agent (counterpart of
``sheeprl_tpu/algos/p2e_dv2/agent.py``).

DreamerV2's world model, actor and critic, plus the stacked next-state
ensemble of ``p2e_dv3/agent.py`` (:class:`~sheeprl_tpu_torch.algos.p2e_dv3.agent.Ensemble`),
an exploration actor and one exploration critic with a target that the step
hard-copies, both Xavier-normal initialized as DreamerV2's own.
"""

from __future__ import annotations

import copy
from typing import Any, Mapping, Optional, Sequence, Tuple

import torch

from sheeprl_tpu_torch.algos.dreamer_v2.agent import (
    MLPHead,
    build_player_fns,
    set_cell_impl,
    xavier_normal_initialization,
)
from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_agent as dv2_build_agent
from sheeprl_tpu_torch.algos.p2e_dv3.agent import Ensemble, build_ensemble
from sheeprl_tpu_torch.device import resolve_device

__all__ = ["Ensemble", "build_agent", "build_player_fns", "set_cell_impl"]


def build_agent(
    cfg,
    actions_dim: Sequence[int],
    is_continuous: bool,
    observation_space: Mapping[str, Any],
    seed: Optional[int] = None,
    device=None,
    training: bool = True,
) -> Tuple[Any, ...]:
    """The P2E-DV2 modules at ``cfg``'s widths on ``device``:
    ``(world_model, actor_task, critic_task, target_critic_task,
    actor_exploration, critic_exploration, target_critic_exploration,
    ensembles)`` in train mode. The DreamerV2 part is DreamerV2's
    ``build_agent`` from ``seed`` (``cfg.seed`` when None); the exploration
    actor and critic (Xavier-normal) and the ensemble (LeCun-normal, no
    LayerNorm unless ``algo.ensembles.layer_norm``) are drawn from a
    generator seeded ``seed + 1``. ``training=False`` is DreamerV2's serving
    build, ``(world_model, actor)``."""
    if not training:
        return dv2_build_agent(cfg, actions_dim, is_continuous, observation_space, seed=seed, device=device)
    dev = resolve_device(device)
    world_model, actor, critic, target_critic = dv2_build_agent(
        cfg, actions_dim, is_continuous, observation_space, seed=seed, device=dev, training=True
    )
    gen = torch.Generator().manual_seed(int(cfg.seed if seed is None else seed) + 1)
    actor_exploration = copy.deepcopy(actor)
    xavier_normal_initialization(actor_exploration, gen)
    critic_cfg = cfg.algo.critic
    wm_cfg = cfg.algo.world_model
    latent = int(wm_cfg.stochastic_size) * int(wm_cfg.discrete_size) + int(wm_cfg.recurrent_model.recurrent_state_size)
    critic_exploration = MLPHead(
        latent, 1, int(critic_cfg.mlp_layers), int(critic_cfg.dense_units), bool(critic_cfg.layer_norm),
        critic_cfg.dense_act,
    )
    xavier_normal_initialization(critic_exploration, gen)
    target_critic_exploration = copy.deepcopy(critic_exploration).requires_grad_(False)
    ensembles = build_ensemble(cfg, actions_dim, gen, layer_norm_default=False, device=dev)
    return (
        world_model, actor, critic, target_critic, actor_exploration.to(dev).train(),
        critic_exploration.to(dev).train(), target_critic_exploration.to(dev).train(), ensembles.train(),
    )

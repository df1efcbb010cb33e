"""Plan2Explore on DreamerV1: the agent (counterpart of
``sheeprl_tpu/algos/p2e_dv1/agent.py``).

DreamerV1's world model, actor and critic, plus the stacked ensemble of
``p2e_dv3/agent.py`` (:class:`~sheeprl_tpu_torch.algos.p2e_dv3.agent.Ensemble`)
predicting the next **observation embedding** (the encoder's output, not
the next stochastic state as in P2E-DV2 and P2E-DV3), an exploration actor
and an exploration critic, both Xavier-normal initialized as DreamerV1's
own. DreamerV1 has no target critic, so neither phase has one.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence, Tuple

import torch

from sheeprl_tpu_torch.algos.dreamer_v1.agent import build_actor, build_critic, build_player_fns
from sheeprl_tpu_torch.algos.dreamer_v1.agent import build_agent as dv1_build_agent
from sheeprl_tpu_torch.algos.dreamer_v2.agent import cnn_encoder_output_dim, xavier_normal_initialization
from sheeprl_tpu_torch.algos.p2e_dv3.agent import Ensemble, build_ensemble
from sheeprl_tpu_torch.device import resolve_device

__all__ = ["Ensemble", "build_agent", "build_player_fns", "embedding_dim"]


def embedding_dim(cfg, cnn_keys: Sequence[str], mlp_keys: Sequence[str]) -> int:
    """The encoder's output width: the CNN's flat features (at
    ``env.screen_size``) and the MLP encoder's ``dense_units``."""
    dim = 0
    if cnn_keys:
        screen = int(cfg.env.screen_size)
        dim += cnn_encoder_output_dim((screen, screen), int(cfg.algo.world_model.encoder.cnn_channels_multiplier))
    if mlp_keys:
        dim += int(cfg.algo.world_model.encoder.dense_units)
    return dim


def build_agent(
    cfg,
    actions_dim: Sequence[int],
    is_continuous: bool,
    observation_space: Mapping[str, Any],
    seed: Optional[int] = None,
    device=None,
    training: bool = True,
) -> Tuple[Any, ...]:
    """The P2E-DV1 modules at ``cfg``'s widths on ``device``:
    ``(world_model, actor_task, critic_task, actor_exploration,
    critic_exploration, ensembles)`` in train mode. The DreamerV1 part is
    DreamerV1's ``build_agent`` from ``seed`` (``cfg.seed`` when None); the
    exploration actor and critic (Xavier-normal) and the ensemble
    (LeCun-normal, no LayerNorm unless ``algo.ensembles.layer_norm``, its
    output the embedding's width) are drawn from a generator seeded ``seed
    + 1``. ``training=False`` is DreamerV1's serving build, ``(world_model,
    actor)``."""
    if not training:
        return dv1_build_agent(cfg, actions_dim, is_continuous, observation_space, seed=seed, device=device)
    dev = resolve_device(device)
    world_model, actor, critic = dv1_build_agent(
        cfg, actions_dim, is_continuous, observation_space, seed=seed, device=dev, training=True
    )
    gen = torch.Generator().manual_seed(int(cfg.seed if seed is None else seed) + 1)
    actor_exploration = build_actor(cfg, actions_dim, is_continuous)
    xavier_normal_initialization(actor_exploration, gen)
    critic_exploration = build_critic(cfg)
    xavier_normal_initialization(critic_exploration, gen)
    output_dim = embedding_dim(cfg, list(cfg.cnn_keys.encoder), list(cfg.mlp_keys.encoder))
    ensembles = build_ensemble(cfg, actions_dim, gen, layer_norm_default=False, device=dev, output_dim=output_dim)
    return (
        world_model, actor, critic, actor_exploration.to(dev).train(), critic_exploration.to(dev).train(),
        ensembles.train(),
    )

"""DreamerV1 agent (counterpart of ``sheeprl_tpu/algos/dreamer_v1/agent.py``).

DreamerV2's encoders, decoders and heads with no LayerNorm (ReLU
convolutions, ELU dense layers), DreamerV3's actor, and DreamerV1's own
core:

- a Gaussian latent: the representation (posterior) and transition (prior)
  heads emit ``2·S`` values, ``mean ‖ raw std``; the state is ``mean +
  (softplus(raw std) + min_std)·ε`` with ``ε`` a pre-drawn standard normal
  (:func:`compute_stochastic_state`);
- the recurrent model: a Linear to the recurrent width and its activation,
  then flax's plain GRU cell (``models.GRUCell``, PyTorch operations; no
  LayerNorm, and not the LayerNorm-GRU kernel of DreamerV2 and V3);
- no ``is_first`` reset anywhere: a sequence starts from zero states and the
  actions are consumed as they are stored (row t holds the action that led
  to observation t).

``build_agent`` Xavier-normal initializes every Linear and convolution
(the GRU's six projections each with its own fans) from a seeded
``torch.Generator``, as the JAX package does with its key. The player is
DreamerV2's with standard-normal posterior noise: all-zero fresh states, no
uniform mix on the actor, pixels in [-0.5, 0.5].

A serving build (``build_agent(..., training=False)``) leaves out the
decoders and the reward and continue heads; a training build has them and
also returns the critic (DreamerV1 has no target critic).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sheeprl_tpu_torch.algos.dreamer_v2.agent import (
    CNNDecoder,
    CNNEncoder,
    MLPDecoder,
    MLPEncoder,
    MLPHead,
    _StochasticModel,
    cnn_encoder_output_dim,
    xavier_normal_initialization,
)
from sheeprl_tpu_torch.algos.dreamer_v2.utils import normalize_obs_tensors
from sheeprl_tpu_torch.algos.dreamer_v3.agent import (
    Actor,
    ExplorationStep,
    actor_noise,
    add_exploration_noise,
    build_actor_dists,
    dreamer_player_fns,
    resolve_actor_distribution,
    sample_actor_actions,
)
from sheeprl_tpu_torch.device import resolve_device
from sheeprl_tpu_torch.models import GRUCell
from sheeprl_tpu_torch.models.models import resolve_activation

__all__ = [
    "Actor",
    "ExplorationStep",
    "MLPHead",
    "RSSM",
    "RecurrentModel",
    "WorldModel",
    "actor_noise",
    "add_exploration_noise",
    "build_actor_dists",
    "build_agent",
    "build_player_fns",
    "compute_stochastic_state",
    "resolve_actor_distribution",
    "sample_actor_actions",
]


def compute_stochastic_state(
    state_information: torch.Tensor,
    min_std: float = 0.1,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[Tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``[..., 2S]`` head output → ``((mean, std), state)``: ``std =
    softplus(raw) + min_std``, ``state = mean + std·noise`` with ``noise`` a
    pre-drawn standard normal ``[..., S]`` (drawn from ``generator`` when
    None)."""
    mean, std = torch.chunk(state_information, 2, dim=-1)
    std = F.softplus(std) + min_std
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator, device=mean.device, dtype=mean.dtype)
    return (mean, std), mean + std * noise


class RecurrentModel(nn.Module):
    """Linear to the recurrent width, its activation, then the GRU cell
    (the JAX module's ``Dense_0`` and ``gru``)."""

    def __init__(self, input_size: int, recurrent_state_size: int, activation: Any = "elu", device=None):
        super().__init__()
        self.linear = nn.Linear(input_size, recurrent_state_size, device=device)
        self.act = resolve_activation(activation)
        self.gru = GRUCell(recurrent_state_size, recurrent_state_size, device=device)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        return self.gru(self.act(self.linear(x)), h)


class RSSM(nn.Module):
    """Gaussian-latent RSSM, single-step methods; the stochastic state is
    ``[..., S]``. No ``is_first`` reset."""

    def __init__(
        self,
        recurrent_state_size: int,
        stochastic_size: int,
        hidden_size: int,
        embed_size: int,
        action_dim: int,
        representation_hidden_size: Optional[int] = None,
        min_std: float = 0.1,
        activation: Any = "elu",
        device=None,
    ):
        super().__init__()
        S, H = int(stochastic_size), int(recurrent_state_size)
        self.min_std = float(min_std)
        self.recurrent_model = RecurrentModel(S + int(action_dim), H, activation, device)
        self.representation_model = _StochasticModel(
            H + int(embed_size), representation_hidden_size or hidden_size, 2 * S, activation=activation, device=device
        )
        self.transition_model = _StochasticModel(H, hidden_size, 2 * S, activation=activation, device=device)

    def _transition(self, recurrent_out, generator=None, noise=None):
        return compute_stochastic_state(self.transition_model(recurrent_out), self.min_std, generator, noise)

    def _representation(self, recurrent_state, embedded_obs, generator=None, noise=None):
        return compute_stochastic_state(
            self.representation_model(torch.cat([recurrent_state, embedded_obs], dim=-1)), self.min_std, generator,
            noise,
        )

    def dynamic_posterior(self, posterior, recurrent_state, action, embedded_obs, noise=None, generator=None):
        """One posterior step of training: recurrent state, then the
        posterior from it and the embedding. Returns ``(recurrent_state,
        posterior, (post_mean, post_std))``; the prior's statistics are
        batched afterwards (:meth:`prior_stats`)."""
        recurrent_state = self.recurrent_model(torch.cat([posterior, action], dim=-1), recurrent_state)
        stats, posterior = self._representation(recurrent_state, embedded_obs, generator, noise)
        return recurrent_state, posterior, stats

    def prior_stats(self, recurrent_states: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The prior's ``(mean, std)`` over any leading shape."""
        mean, std = torch.chunk(self.transition_model(recurrent_states), 2, dim=-1)
        return mean, F.softplus(std) + self.min_std

    def imagination(self, prior, recurrent_state, actions, noise=None, generator=None):
        """One prior step in imagination: returns ``(prior, recurrent_state)``."""
        recurrent_state = self.recurrent_model(torch.cat([prior, actions], dim=-1), recurrent_state)
        _, imagined_prior = self._transition(recurrent_state, generator, noise)
        return imagined_prior, recurrent_state


class WorldModel(nn.Module):
    """Encoders plus the RSSM (what the player runs), and with ``training``
    the decoders and the reward and continue heads."""

    def __init__(
        self,
        cnn_keys: Sequence[str],
        mlp_keys: Sequence[str],
        cnn_channels: Sequence[int],
        mlp_dims: Sequence[int],
        image_size: Tuple[int, int],
        channels_multiplier: int,
        encoder_mlp_layers: int,
        dense_units: int,
        recurrent_state_size: int,
        stochastic_size: int,
        hidden_size: int,
        action_dim: int,
        representation_hidden_size: Optional[int] = None,
        min_std: float = 0.1,
        cnn_act: Any = "relu",
        dense_act: Any = "elu",
        training: bool = False,
        decoder_mlp_layers: int = 4,
        reward_mlp_layers: int = 4,
        reward_dense_units: int = 400,
        continue_mlp_layers: int = 4,
        continue_dense_units: int = 400,
        use_continues: bool = False,
        device=None,
    ):
        super().__init__()
        self.cnn_keys, self.mlp_keys = list(cnn_keys), list(mlp_keys)
        self.cnn_channels = [int(c) for c in cnn_channels]
        embed = 0
        self.cnn_encoder = self.mlp_encoder = None
        if self.cnn_keys:
            self.cnn_encoder = CNNEncoder(self.cnn_keys, sum(cnn_channels), channels_multiplier, False, cnn_act, device)
            embed += cnn_encoder_output_dim(image_size, channels_multiplier)
        if self.mlp_keys:
            self.mlp_encoder = MLPEncoder(
                self.mlp_keys, sum(mlp_dims), encoder_mlp_layers, dense_units, False, dense_act, device
            )
            embed += dense_units
        self.rssm = RSSM(
            recurrent_state_size, stochastic_size, hidden_size, embed_size=embed, action_dim=action_dim,
            representation_hidden_size=representation_hidden_size, min_std=min_std, activation=dense_act,
            device=device,
        )
        self.cnn_decoder = self.mlp_decoder = self.reward_model = self.continue_model = None
        if not training:
            return
        latent = int(stochastic_size) + int(recurrent_state_size)
        if self.cnn_keys:
            self.cnn_decoder = CNNDecoder(
                cnn_channels, channels_multiplier, latent, cnn_encoder_output_dim(image_size, channels_multiplier),
                False, cnn_act, device,
            )
        if self.mlp_keys:
            self.mlp_decoder = MLPDecoder(
                self.mlp_keys, mlp_dims, latent, decoder_mlp_layers, dense_units, False, dense_act, device
            )
        self.reward_model = MLPHead(latent, 1, reward_mlp_layers, reward_dense_units, False, dense_act, device)
        if use_continues:
            self.continue_model = MLPHead(latent, 1, continue_mlp_layers, continue_dense_units, False, dense_act,
                                          device)

    def encode(self, obs: Mapping[str, torch.Tensor]) -> torch.Tensor:
        feats = []
        if self.cnn_encoder is not None:
            feats.append(self.cnn_encoder(obs))
        if self.mlp_encoder is not None:
            feats.append(self.mlp_encoder(obs))
        return torch.cat(feats, dim=-1) if len(feats) > 1 else feats[0]

    def recurrent_step(self, stochastic, actions, recurrent_state):
        return self.rssm.recurrent_model(torch.cat([stochastic, actions], dim=-1), recurrent_state)

    def representation(self, recurrent_state, embedded_obs, generator=None, noise=None):
        """``((mean, std), posterior)``; ``noise`` the posterior's standard normals."""
        return self.rssm._representation(recurrent_state, embedded_obs, generator, noise)

    def decode(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Reconstructions per key: ``[..., C, H, W]`` images split by the
        keys' channels, ``[..., dim]`` vectors."""
        out: Dict[str, torch.Tensor] = {}
        if self.cnn_decoder is not None:
            rec = self.cnn_decoder(latent)
            out.update(zip(self.cnn_keys, torch.split(rec, self.cnn_channels, dim=-3)))
        if self.mlp_decoder is not None:
            out.update(self.mlp_decoder(latent))
        return out

    def reward(self, latent: torch.Tensor) -> torch.Tensor:
        return self.reward_model(latent)

    def continues(self, latent: torch.Tensor) -> torch.Tensor:
        return self.continue_model(latent)


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------


def _shape_of(space) -> Tuple[int, ...]:
    return tuple(getattr(space, "shape", space))


def build_actor(cfg, actions_dim: Sequence[int], is_continuous: bool) -> Actor:
    """The actor at ``cfg``'s widths (no LayerNorm), not yet initialized."""
    wm_cfg = cfg.algo.world_model
    latent = int(wm_cfg.stochastic_size) + int(wm_cfg.recurrent_model.recurrent_state_size)
    return Actor(
        latent,
        actions_dim,
        is_continuous,
        distribution=resolve_actor_distribution(cfg.distribution.get("type", "auto"), is_continuous),
        dense_units=int(cfg.algo.actor.dense_units),
        mlp_layers=int(cfg.algo.actor.mlp_layers),
        layer_norm=False,
        activation=cfg.algo.actor.dense_act,
    )


def build_critic(cfg) -> MLPHead:
    """The critic at ``cfg``'s widths (no LayerNorm), not yet initialized."""
    wm_cfg = cfg.algo.world_model
    latent = int(wm_cfg.stochastic_size) + int(wm_cfg.recurrent_model.recurrent_state_size)
    critic_cfg = cfg.algo.critic
    return MLPHead(latent, 1, int(critic_cfg.mlp_layers), int(critic_cfg.dense_units), False, critic_cfg.dense_act)


def build_agent(
    cfg,
    actions_dim: Sequence[int],
    is_continuous: bool,
    observation_space: Mapping[str, Any],
    seed: Optional[int] = None,
    device=None,
    training: bool = False,
):
    """World model and actor at ``cfg``'s widths, Xavier-normal initialized
    from ``seed`` (``cfg.seed`` when None) and placed on ``device``.
    ``observation_space`` maps each key to a space with ``.shape`` or to a
    shape tuple.

    Returns ``(world_model, actor)`` in eval mode. With ``training=True``
    the world model also has its decoders and heads, and the result is
    ``(world_model, actor, critic)`` in train mode."""
    dev = resolve_device(device)
    wm_cfg = cfg.algo.world_model
    cnn_keys, mlp_keys = list(cfg.cnn_keys.encoder), list(cfg.mlp_keys.encoder)
    screen = int(cfg.env.screen_size)
    world_model = WorldModel(
        cnn_keys=cnn_keys,
        mlp_keys=mlp_keys,
        cnn_channels=[int(np.prod(_shape_of(observation_space[k])[:-2])) for k in cnn_keys],
        mlp_dims=[int(np.prod(_shape_of(observation_space[k]))) for k in mlp_keys],
        image_size=(screen, screen),
        channels_multiplier=int(wm_cfg.encoder.cnn_channels_multiplier),
        encoder_mlp_layers=int(wm_cfg.encoder.mlp_layers),
        dense_units=int(wm_cfg.encoder.dense_units),
        recurrent_state_size=int(wm_cfg.recurrent_model.recurrent_state_size),
        stochastic_size=int(wm_cfg.stochastic_size),
        hidden_size=int(wm_cfg.transition_model.hidden_size),
        action_dim=int(np.sum(actions_dim)),
        representation_hidden_size=int(wm_cfg.representation_model.hidden_size),
        min_std=float(wm_cfg.min_std),
        cnn_act=cfg.algo.cnn_act,
        dense_act=cfg.algo.dense_act,
        training=training,
        decoder_mlp_layers=int(wm_cfg.observation_model.mlp_layers),
        reward_mlp_layers=int(wm_cfg.reward_model.mlp_layers),
        reward_dense_units=int(wm_cfg.reward_model.dense_units),
        continue_mlp_layers=int(wm_cfg.discount_model.mlp_layers),
        continue_dense_units=int(wm_cfg.discount_model.dense_units),
        use_continues=bool(wm_cfg.use_continues),
    )
    actor = build_actor(cfg, actions_dim, is_continuous)
    gen = torch.Generator().manual_seed(int(cfg.seed if seed is None else seed))
    xavier_normal_initialization(world_model, gen)
    xavier_normal_initialization(actor, gen)
    if not training:
        return world_model.to(dev).eval(), actor.to(dev).eval()
    critic = build_critic(cfg)
    xavier_normal_initialization(critic, gen)
    return world_model.to(dev).train(), actor.to(dev).train(), critic.to(dev).train()


# ---------------------------------------------------------------------------
# player
# ---------------------------------------------------------------------------


def build_player_fns(
    world_model: WorldModel, actor: Actor, cfg, actions_dim: Sequence[int], is_continuous: bool
) -> Dict[str, Any]:
    """DreamerV1's player (:func:`~sheeprl_tpu_torch.algos.dreamer_v3.agent.dreamer_player_fns`):
    a fresh state is all zeros, the posterior's noise is standard normals
    ``[n, S]`` (passed as ``gumbel``, the player contract's name), the
    actor's categoricals take no uniform mix, pixels are scaled to [-0.5,
    0.5]; the exploration action adds ``add_exploration_noise`` at
    ``expl_amount``."""
    return dreamer_player_fns(
        world_model, actor, cfg, actions_dim, is_continuous, unimix=0.0, initial_posterior=None,
        normalize=normalize_obs_tensors, gaussian_posterior=True,
    )

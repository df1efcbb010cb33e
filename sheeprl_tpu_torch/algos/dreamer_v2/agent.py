"""DreamerV2 agent (counterpart of ``sheeprl_tpu/algos/dreamer_v2/agent.py``).

What is here: the encoders and decoders, the reward, continue and critic
heads, the RSSM's single steps (the player's ``recurrent_model`` /
``_representation`` / ``_transition``, and training's ``dynamic_posterior``
with its ``is_first`` masks, ``prior_logits`` batched over any leading shape
and ``imagination``), a world model with the player's and training's
methods, the seeded Xavier-normal ``build_agent``, and the player
(``build_player_fns``: DreamerV3's ``dreamer_player_fns`` with all-zero
fresh states, no uniform mix on the actor and pixels in [-0.5, 0.5]; the
training loop's acting step, :class:`ExplorationStep`, is DreamerV3's too).

A serving build (``build_agent(..., training=False)``) leaves out the
decoders and the reward and continue heads; a training build has them and
also returns the critic and its target copy.

The recurrent core's LayerNorm-GRU step (``RecurrentModel.gru``) is the CUDA
kernel ``kernels/csrc/hafner_gru.cu`` on the card.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from sheeprl_tpu_torch.algos.dreamer_v3.agent import (
    Actor,
    ExplorationStep,
    actor_entropy,
    actor_noise,
    build_actor_dists,
    compute_stochastic_state,
    dreamer_player_fns,
    resolve_actor_distribution,
    sample_actor_actions,
)
from sheeprl_tpu_torch.algos.dreamer_v2.utils import normalize_obs_tensors
from sheeprl_tpu_torch.device import resolve_device
from sheeprl_tpu_torch.models import CNN, MLP, DeCNN, LayerNormGRUCell

__all__ = [
    "Actor",
    "CNNDecoder",
    "CNNEncoder",
    "MLPDecoder",
    "MLPEncoder",
    "MLPHead",
    "RSSM",
    "RecurrentModel",
    "WorldModel",
    "actor_entropy",
    "actor_noise",
    "build_actor_dists",
    "build_agent",
    "build_player_fns",
    "cnn_encoder_output_dim",
    "ExplorationStep",
    "compute_stochastic_state",
    "resolve_actor_distribution",
    "sample_actor_actions",
    "set_cell_impl",
    "xavier_normal_initialization",
]


class CNNEncoder(nn.Module):
    """Four k=4/s=2 valid conv stages, channels ``[1, 2, 4, 8] × multiplier``,
    flattened in NHWC order. Input ``obs[k]`` is ``[..., C, H, W]``."""

    def __init__(self, keys, in_channels, channels_multiplier, layer_norm=False, activation="elu", device=None):
        super().__init__()
        self.keys = list(keys)
        self.cnn = CNN(
            in_channels,
            [m * channels_multiplier for m in (1, 2, 4, 8)],
            kernel_sizes=4,
            strides=2,
            paddings=0,
            activation=activation,
            layer_norm=layer_norm,
            flatten=True,
            device=device,
        )

    def forward(self, obs: Mapping[str, torch.Tensor]) -> torch.Tensor:
        return self.cnn(torch.cat([obs[k] for k in self.keys], dim=-3))


def cnn_encoder_output_dim(image_size: Tuple[int, int], channels_multiplier: int) -> int:
    """Flat width after four valid k=4/s=2 stages."""
    h, w = image_size
    for _ in range(4):
        h, w = (h - 4) // 2 + 1, (w - 4) // 2 + 1
    return 8 * channels_multiplier * h * w


class MLPEncoder(nn.Module):
    """Vector encoder: ``mlp_layers`` dense blocks."""

    def __init__(self, keys, input_dim, mlp_layers=4, dense_units=400, layer_norm=False, activation="elu", device=None):
        super().__init__()
        self.keys = list(keys)
        self.mlp = MLP(
            input_dim, [dense_units] * mlp_layers, activation=activation, layer_norm=layer_norm, device=device
        )

    def forward(self, obs: Mapping[str, torch.Tensor]) -> torch.Tensor:
        return self.mlp(torch.cat([obs[k] for k in self.keys], dim=-1))


class CNNDecoder(nn.Module):
    """Pixel decoder: a Linear projection of the latent to the encoder's flat
    width, read as a 1×1 map, then four transposed convs (k=5,5,6,6, s=2) back
    to ``[..., C, 64, 64]``."""

    def __init__(
        self, output_channels, channels_multiplier, latent_size, cnn_encoder_output_dim,
        layer_norm=False, activation="elu", device=None,
    ):
        super().__init__()
        self.linear = nn.Linear(latent_size, cnn_encoder_output_dim, device=device)
        self.decnn = DeCNN(
            cnn_encoder_output_dim,
            [m * channels_multiplier for m in (4, 2, 1)] + [sum(int(c) for c in output_channels)],
            kernel_sizes=[5, 5, 6, 6],
            strides=2,
            paddings=0,
            activation=activation,
            layer_norm=[layer_norm] * 3 + [False],
            device=device,
        )

    def forward(self, latent: torch.Tensor) -> torch.Tensor:
        x = self.linear(latent)
        return self.decnn(x.reshape(x.shape + (1, 1)))


class MLPDecoder(nn.Module):
    """Vector decoder: a dense trunk and one Linear head per key."""

    def __init__(self, keys, output_dims, latent_size, mlp_layers=4, dense_units=400, layer_norm=False,
                 activation="elu", device=None):
        super().__init__()
        self.keys = list(keys)
        self.mlp = MLP(latent_size, [dense_units] * mlp_layers, activation=activation, layer_norm=layer_norm,
                       device=device)
        self.heads = nn.ModuleDict({k: nn.Linear(dense_units, int(d), device=device) for k, d in zip(keys, output_dims)})

    def forward(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.mlp(latent)
        return {k: self.heads[k](x) for k in self.keys}


class MLPHead(nn.Module):
    """Dense trunk and one Linear head: the reward, continue and critic heads."""

    def __init__(self, input_dim, output_dim, mlp_layers, dense_units, layer_norm=False, activation="elu",
                 device=None):
        super().__init__()
        self.mlp = MLP(input_dim, [dense_units] * mlp_layers, activation=activation, layer_norm=layer_norm,
                       device=device)
        self.head = nn.Linear(dense_units, output_dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.mlp(x))


class RecurrentModel(nn.Module):
    """Dense pre-layer, then the LayerNorm-GRU cell (bias on, LayerNorm on,
    eps 1e-5 as in the JAX module)."""

    def __init__(self, input_size, recurrent_state_size, dense_units, layer_norm=True, activation="elu", device=None):
        super().__init__()
        self.mlp = MLP(input_size, [dense_units], activation=activation, layer_norm=layer_norm, device=device)
        self.gru = LayerNormGRUCell(
            dense_units, recurrent_state_size, bias=True, layer_norm=True, norm_eps=1e-5, device=device
        )

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        return self.gru(self.mlp(x), h)


class _StochasticModel(nn.Module):
    """Dense trunk plus a logits head: the transition (prior) and
    representation (posterior) models."""

    def __init__(self, input_size, hidden_size, stoch_size, layer_norm=False, activation="elu", device=None):
        super().__init__()
        self.mlp = MLP(input_size, [hidden_size], activation=activation, layer_norm=layer_norm, device=device)
        self.head = nn.Linear(hidden_size, stoch_size, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.mlp(x))


class RSSM(nn.Module):
    """Discrete-latent RSSM, single-step methods. The stochastic state is
    carried flat ``[..., S*D]``."""

    def __init__(
        self,
        recurrent_state_size: int,
        stochastic_size: int,
        discrete_size: int,
        dense_units: int,
        hidden_size: int,
        embed_size: int,
        action_dim: int,
        representation_hidden_size: Optional[int] = None,
        layer_norm: bool = False,
        recurrent_layer_norm: bool = True,
        activation: Any = "elu",
        device=None,
    ):
        super().__init__()
        self.discrete_size = int(discrete_size)
        stoch = int(stochastic_size) * self.discrete_size
        H = int(recurrent_state_size)
        self.recurrent_model = RecurrentModel(
            stoch + int(action_dim), H, dense_units, layer_norm=recurrent_layer_norm,
            activation=activation, device=device,
        )
        self.representation_model = _StochasticModel(
            H + int(embed_size), representation_hidden_size or hidden_size, stoch,
            layer_norm=layer_norm, activation=activation, device=device,
        )
        self.transition_model = _StochasticModel(
            H, hidden_size, stoch, layer_norm=layer_norm, activation=activation, device=device
        )

    def _transition(self, recurrent_out, generator=None, sample_state=True, gumbel=None):
        logits = self.transition_model(recurrent_out)
        return logits, compute_stochastic_state(
            logits, self.discrete_size, generator, sample=sample_state, gumbel=gumbel
        )

    def _representation(self, recurrent_state, embedded_obs, generator=None, gumbel=None):
        logits = self.representation_model(torch.cat([recurrent_state, embedded_obs], dim=-1))
        return logits, compute_stochastic_state(logits, self.discrete_size, generator, gumbel=gumbel)

    def dynamic_posterior(self, posterior, recurrent_state, action, embedded_obs, is_first, gumbel=None,
                          generator=None):
        """One posterior step of training: an ``is_first`` row starts from
        zeros (action, posterior and recurrent state), then recurrent →
        posterior. Returns ``(recurrent_state, posterior, posterior_logits)``;
        the prior logits are batched afterwards (:meth:`prior_logits`)."""
        keep = 1.0 - is_first
        action, posterior, recurrent_state = keep * action, keep * posterior, keep * recurrent_state
        recurrent_state = self.recurrent_model(torch.cat([posterior, action], dim=-1), recurrent_state)
        posterior_logits, posterior = self._representation(recurrent_state, embedded_obs, generator, gumbel=gumbel)
        return recurrent_state, posterior, posterior_logits

    def prior_logits(self, recurrent_states: torch.Tensor) -> torch.Tensor:
        """Transition logits over any leading shape."""
        return self.transition_model(recurrent_states)

    def imagination(self, prior, recurrent_state, actions, gumbel=None, generator=None):
        """One prior step in imagination: returns ``(prior, recurrent_state)``."""
        recurrent_state = self.recurrent_model(torch.cat([prior, actions], dim=-1), recurrent_state)
        _, imagined_prior = self._transition(recurrent_state, generator, gumbel=gumbel)
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
        discrete_size: int,
        hidden_size: int,
        action_dim: int,
        representation_hidden_size: Optional[int] = None,
        layer_norm: bool = False,
        cnn_act: Any = "elu",
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
            self.cnn_encoder = CNNEncoder(
                self.cnn_keys, sum(cnn_channels), channels_multiplier, layer_norm, cnn_act, device
            )
            embed += cnn_encoder_output_dim(image_size, channels_multiplier)
        if self.mlp_keys:
            self.mlp_encoder = MLPEncoder(
                self.mlp_keys, sum(mlp_dims), encoder_mlp_layers, dense_units, layer_norm, dense_act, device
            )
            embed += dense_units
        self.rssm = RSSM(
            recurrent_state_size, stochastic_size, discrete_size, dense_units, hidden_size,
            embed_size=embed, action_dim=action_dim,
            representation_hidden_size=representation_hidden_size,
            layer_norm=layer_norm, activation=dense_act, device=device,
        )
        self.cnn_decoder = self.mlp_decoder = self.reward_model = self.continue_model = None
        if not training:
            return
        latent = int(stochastic_size) * int(discrete_size) + int(recurrent_state_size)
        if self.cnn_keys:
            self.cnn_decoder = CNNDecoder(
                cnn_channels, channels_multiplier, latent, cnn_encoder_output_dim(image_size, channels_multiplier),
                layer_norm, cnn_act, device,
            )
        if self.mlp_keys:
            self.mlp_decoder = MLPDecoder(
                self.mlp_keys, mlp_dims, latent, decoder_mlp_layers, dense_units, layer_norm, dense_act, device
            )
        self.reward_model = MLPHead(latent, 1, reward_mlp_layers, reward_dense_units, layer_norm, dense_act, device)
        if use_continues:
            self.continue_model = MLPHead(
                latent, 1, continue_mlp_layers, continue_dense_units, layer_norm, dense_act, device
            )

    def encode(self, obs: Mapping[str, torch.Tensor]) -> torch.Tensor:
        feats = []
        if self.cnn_encoder is not None:
            feats.append(self.cnn_encoder(obs))
        if self.mlp_encoder is not None:
            feats.append(self.mlp_encoder(obs))
        return torch.cat(feats, dim=-1) if len(feats) > 1 else feats[0]

    def recurrent_step(self, stochastic, actions, recurrent_state):
        return self.rssm.recurrent_model(torch.cat([stochastic, actions], dim=-1), recurrent_state)

    def representation(self, recurrent_state, embedded_obs, generator=None, gumbel=None):
        return self.rssm._representation(recurrent_state, embedded_obs, generator, gumbel=gumbel)

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


def xavier_normal_initialization(module: nn.Module, generator: torch.Generator) -> None:
    """Every Linear/Conv weight and the GRU's joint kernel Xavier-normal,
    biases zero, LayerNorm affine left at ones/zeros (the JAX transform)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                w = m.weight  # [out, in(, kh, kw)]; [in, out, kh, kw] transposed (the sum is what counts)
                space = int(np.prod(w.shape[2:])) if w.dim() > 2 else 1
                fan_in, fan_out = w.shape[1] * space, w.shape[0] * space
            elif isinstance(m, LayerNormGRUCell):
                w = m.weight  # [in, out], the JAX layout
                fan_in, fan_out = w.shape
            else:
                continue
            std = float(np.sqrt(2.0 / (fan_in + fan_out)))
            w.copy_(std * torch.randn(w.shape, generator=generator))
            if m.bias is not None:
                m.bias.zero_()


def _shape_of(space) -> Tuple[int, ...]:
    return tuple(getattr(space, "shape", space))


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

    Returns ``(world_model, actor)`` in eval mode. With ``training=True`` the
    world model also has its decoders and heads, and the result is
    ``(world_model, actor, critic, target_critic)`` in train mode, the target
    a copy of the critic whose parameters take no gradient."""
    dev = resolve_device(device)
    wm_cfg = cfg.algo.world_model
    cnn_keys, mlp_keys = list(cfg.cnn_keys.encoder), list(cfg.mlp_keys.encoder)
    screen = int(cfg.env.screen_size)
    cnn_channels = [int(np.prod(_shape_of(observation_space[k])[:-2])) for k in cnn_keys]
    mlp_dims = [int(np.prod(_shape_of(observation_space[k]))) for k in mlp_keys]
    world_model = WorldModel(
        cnn_keys=cnn_keys,
        mlp_keys=mlp_keys,
        cnn_channels=cnn_channels,
        mlp_dims=mlp_dims,
        image_size=(screen, screen),
        channels_multiplier=int(wm_cfg.encoder.cnn_channels_multiplier),
        encoder_mlp_layers=int(wm_cfg.encoder.mlp_layers),
        dense_units=int(wm_cfg.encoder.dense_units),
        recurrent_state_size=int(wm_cfg.recurrent_model.recurrent_state_size),
        stochastic_size=int(wm_cfg.stochastic_size),
        discrete_size=int(wm_cfg.discrete_size),
        hidden_size=int(wm_cfg.transition_model.hidden_size),
        action_dim=int(np.sum(actions_dim)),
        representation_hidden_size=int(wm_cfg.representation_model.hidden_size),
        layer_norm=bool(cfg.algo.layer_norm),
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
    latent = int(wm_cfg.stochastic_size) * int(wm_cfg.discrete_size) + int(
        wm_cfg.recurrent_model.recurrent_state_size
    )
    actor = Actor(
        latent,
        actions_dim,
        is_continuous,
        distribution=resolve_actor_distribution(cfg.distribution.get("type", "auto"), is_continuous),
        dense_units=int(cfg.algo.actor.dense_units),
        mlp_layers=int(cfg.algo.actor.mlp_layers),
        layer_norm=bool(cfg.algo.actor.layer_norm),
        activation=cfg.algo.actor.dense_act,
    )
    gen = torch.Generator().manual_seed(int(cfg.seed if seed is None else seed))
    xavier_normal_initialization(world_model, gen)
    xavier_normal_initialization(actor, gen)
    if not training:
        return world_model.to(dev).eval(), actor.to(dev).eval()
    critic_cfg = cfg.algo.critic
    critic = MLPHead(
        latent, 1, int(critic_cfg.mlp_layers), int(critic_cfg.dense_units), bool(critic_cfg.layer_norm),
        critic_cfg.dense_act,
    )
    xavier_normal_initialization(critic, gen)
    target_critic = copy.deepcopy(critic).requires_grad_(False)
    return world_model.to(dev).train(), actor.to(dev).train(), critic.to(dev).train(), target_critic.to(dev).train()


def set_cell_impl(world_model: WorldModel, impl: str) -> None:
    """``"plain"`` runs the recurrent cell's plain PyTorch version on any
    device (to hold the CUDA kernel against it); ``"auto"`` restores the
    kernel on the card."""
    world_model.rssm.recurrent_model.gru.impl = impl


# ---------------------------------------------------------------------------
# player
# ---------------------------------------------------------------------------


def build_player_fns(
    world_model: WorldModel, actor: Actor, cfg, actions_dim: Sequence[int], is_continuous: bool
) -> Dict[str, Any]:
    """DreamerV2's player (:func:`~sheeprl_tpu_torch.algos.dreamer_v3.agent.dreamer_player_fns`):
    a fresh state is all zeros, the actor's categoricals take no uniform
    mix, pixels are scaled to [-0.5, 0.5]."""
    return dreamer_player_fns(
        world_model, actor, cfg, actions_dim, is_continuous, unimix=0.0, initial_posterior=None,
        normalize=normalize_obs_tensors,
    )

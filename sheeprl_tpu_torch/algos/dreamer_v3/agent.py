"""DreamerV3 agent (counterpart of ``sheeprl_tpu/algos/dreamer_v3/agent.py``).

What is here: the encoders and decoders (channel-last LayerNorm with eps
1e-3, SiLU, no bias where a LayerNorm follows; k=4/s=2/p=1 stages), the
reward, continue and critic heads (:class:`MLPWithHead`), the RSSM's single
steps with the 1% uniform mix on every categorical and the posterior
trunk's embed half split out (:meth:`RSSM.project_embed`, batched over the
whole sequence before the time loop), a world model with the player's and
training's methods, the Hafner initialization, ``build_agent``, the actor
and its distributions (discrete actions), and the player functions and the
training loop's acting step that DreamerV2 shares (:func:`dreamer_player_fns`,
:class:`ExplorationStep`, a CUDA graph on the card).

The recurrent cell is ``LayerNormGRUCell(bias=False, layer_norm=True)``
with eps 1e-3; on the card it is the CUDA kernel
``kernels/csrc/hafner_gru.cu``.

Every module takes the compute ``dtype`` that ``build_agent`` reads from
``fabric.precision`` (None for f32, bf16 under ``bf16-mixed``), as the JAX
modules do: parameters stay f32, activations compute in ``dtype``, every
head's output is cast back to f32 (the reconstruction stays in ``dtype``,
as the JAX decoder's), and the recurrent cell takes its bf16 operand path
and returns the f32 state.

A serving build (``build_agent(..., training=False)``) leaves out the
decoders and the reward and continue heads; a training build has them and
also returns the critic and its target copy. A continuous actor has one head
of width ``2·Σdims`` (mean and std) read as a ``trunc_normal`` (the
default), ``normal`` or ``tanh_normal``; it samples with ``rsample`` when
acting and in training, and greedily as the best of 100 samples by
``log_prob``.
"""

from __future__ import annotations

import copy
import math
import re
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sheeprl_tpu_torch.algos.dreamer_v3.utils import normalize_obs_tensors
from sheeprl_tpu_torch.device import resolve_device
from sheeprl_tpu_torch.distributions import (
    Independent,
    Normal,
    OneHotCategoricalStraightThrough,
    TanhNormal,
    TruncatedNormal,
    gumbel_noise,
    symlog,
    truncated_uniform_noise,
)
from sheeprl_tpu_torch.fabric import compute_dtype_from_precision
from sheeprl_tpu_torch.models.models import CNN, MLP, DeCNN, LayerNormGRUCell, Linear, resolve_activation
from sheeprl_tpu_torch.models.norm import FastLayerNorm
from sheeprl_tpu_torch.obs.counters import add_rollout_burst
from sheeprl_tpu_torch.train.graphs import CapturedStep

__all__ = [
    "Actor",
    "CNNDecoder",
    "CNNEncoder",
    "ExplorationStep",
    "MLPDecoder",
    "MLPEncoder",
    "MLPWithHead",
    "RSSM",
    "RecurrentModel",
    "WorldModel",
    "actor_entropy",
    "actor_noise",
    "add_exploration_noise",
    "build_actor_dists",
    "build_agent",
    "build_player_fns",
    "compute_stochastic_state",
    "dreamer_player_fns",
    "encoder_output_dim",
    "hafner_initialization",
    "resolve_actor_distribution",
    "sample_actor_actions",
    "set_cell_impl",
    "uniform_mix",
]

_EPS = 1e-3  # every LayerNorm of the DreamerV3 modules
#: samples a continuous actor's greedy action is the best of (by log_prob)
GREEDY_SAMPLES = 100


# ---------------------------------------------------------------------------
# actor
# ---------------------------------------------------------------------------


class Actor(nn.Module):
    """Dense trunk plus one Linear head per discrete sub-action, or one head
    of width ``2·Σdims`` (mean and std) for continuous actions. Returns the
    raw head outputs, one tensor per head."""

    def __init__(
        self,
        latent_size: int,
        actions_dim: Sequence[int],
        is_continuous: bool,
        distribution: str = "auto",
        dense_units: int = 1024,
        mlp_layers: int = 5,
        layer_norm: bool = True,
        activation="silu",
        device=None,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.actions_dim = tuple(int(d) for d in actions_dim)
        self.distribution = distribution
        self.mlp = MLP(
            latent_size,
            [dense_units] * mlp_layers,
            activation=activation,
            layer_norm=layer_norm,
            norm_eps=_EPS,
            bias=not layer_norm,
            device=device,
            dtype=dtype,
        )
        widths = (2 * sum(self.actions_dim),) if is_continuous else self.actions_dim
        self.heads = nn.ModuleList(Linear(self.mlp.output_dim, dim, device=device, dtype=dtype) for dim in widths)

    def forward(self, state: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = self.mlp(state)
        return tuple(head(x).float() for head in self.heads)


def resolve_actor_distribution(distribution: str, is_continuous: bool) -> str:
    dist = (distribution or "auto").lower()
    if dist not in ("auto", "normal", "tanh_normal", "discrete", "trunc_normal"):
        raise ValueError(
            "The distribution must be on of: `auto`, `discrete`, `normal`, "
            f"`tanh_normal` and `trunc_normal`. Found: {dist}"
        )
    if dist == "discrete" and is_continuous:
        raise ValueError("You have choose a discrete distribution but `is_continuous` is true")
    if dist == "auto":
        dist = "trunc_normal" if is_continuous else "discrete"
    return dist


def build_actor_dists(
    pre_dist: Sequence[torch.Tensor],
    is_continuous: bool,
    distribution: str,
    init_std: float = 0.0,
    min_std: float = 0.1,
    unimix: float = 0.01,
) -> list:
    """Head outputs → the actor's distributions: one straight-through
    categorical per sub-action, with an optional uniform mix of the
    probabilities; or for continuous actions one :class:`Independent` over
    the single head's ``(mean, std)`` halves: ``trunc_normal`` on [−1, 1] at
    ``tanh(mean)`` with std ``2·sigmoid((std + init_std)/2) + min_std``,
    ``normal`` as it is, ``tanh_normal`` at ``5·tanh(mean/5)`` with std
    ``softplus(std + init_std) + min_std``."""
    if is_continuous:
        mean, std = torch.chunk(pre_dist[0], 2, dim=-1)
        if distribution == "tanh_normal":
            mean = 5.0 * torch.tanh(mean / 5.0)
            std = F.softplus(std + init_std) + min_std
            return [Independent(TanhNormal(mean, std), 1)]
        if distribution == "normal":
            return [Independent(Normal(mean, std), 1)]
        if distribution == "trunc_normal":
            std = 2.0 * torch.sigmoid((std + init_std) / 2.0) + min_std
            return [Independent(TruncatedNormal(torch.tanh(mean), std, -1.0, 1.0), 1)]
        raise ValueError(f"Unknown continuous distribution '{distribution}'")
    dists = []
    for logits in pre_dist:
        probs = F.softmax(logits, dim=-1)
        if unimix > 0.0:
            probs = (1.0 - unimix) * probs + unimix / probs.shape[-1]
        dists.append(OneHotCategoricalStraightThrough(logits=torch.log(probs)))
    return dists


def actor_noise(distribution: str, shape, generator: Optional[torch.Generator] = None, device=None) -> torch.Tensor:
    """Pre-drawn noise for one head's samples of shape ``shape``: Gumbels for
    a categorical (``discrete``), uniforms on ``[1e-6, 1 − 1e-6]`` for a
    ``trunc_normal`` (its inverse cdf's), standard normals for a ``normal``
    or ``tanh_normal``."""
    if distribution == "discrete":
        return gumbel_noise(shape, generator, device)
    if distribution == "trunc_normal":
        return truncated_uniform_noise(shape, generator, device)
    return torch.randn(shape, generator=generator, device=device)


def sample_actor_actions(
    dists: Sequence[Any],
    is_continuous: bool,
    generator: Optional[torch.Generator] = None,
    is_training: bool = True,
    noise: Optional[Sequence[torch.Tensor]] = None,
) -> List[torch.Tensor]:
    """A (straight-through or reparameterized) sample per distribution when
    training; greedily the mode of a categorical, or for continuous actions
    the best of GREEDY_SAMPLES samples by ``log_prob`` (the first of equal
    ones, as ``argmax`` takes it). ``noise`` holds pre-drawn noise, one
    tensor per distribution (:func:`actor_noise`, shaped like its actions,
    with a leading axis of GREEDY_SAMPLES for a greedy continuous action;
    the JAX side draws it per head from ``split(key)``); without it the
    noise comes from ``generator``."""
    if not is_continuous:
        if not is_training:
            return [d.mode for d in dists]
        if noise is None:
            return [d.rsample(generator) for d in dists]
        return [d.rsample(gumbel=g) for d, g in zip(dists, noise)]
    noise = [None] * len(dists) if noise is None else noise
    if is_training:
        return [d.rsample(generator=generator, noise=n) for d, n in zip(dists, noise)]
    actions = []
    for d, n in zip(dists, noise):
        samples = d.sample((GREEDY_SAMPLES,), generator, noise=n)
        best = d.log_prob(samples).argmax(dim=0)
        actions.append(samples.gather(0, best[None, ..., None].expand((1,) + samples.shape[1:]))[0])
    return actions


def actor_entropy(dists: Sequence[Any], distribution: str = "discrete") -> torch.Tensor:
    """Summed per-head entropy; ``tanh_normal`` has no closed form and gives
    zeros."""
    if distribution == "tanh_normal":
        loc = dists[0].base.base.loc
        return torch.zeros(loc.shape[:-1], dtype=loc.dtype, device=loc.device)
    return sum(d.entropy() for d in dists)


def add_exploration_noise(
    actions: Sequence[torch.Tensor], expl_amount: torch.Tensor, is_continuous: bool, noise: Sequence[Any]
) -> List[torch.Tensor]:
    """Exploration on sampled actions, selected by the device scalar
    ``expl_amount`` (no host branch, so that it replays from a CUDA graph).
    Continuous: ``clip(a + expl_amount·ε, −1, 1)`` where ``expl_amount > 0``,
    ``noise`` one standard normal ``ε`` shaped like the concatenated
    actions. Discrete: a row's action becomes the uniform category where ``u
    < expl_amount``, ``noise`` per head ``(uniform_category [n], u [n,
    1])``."""
    if is_continuous:
        cat = torch.cat(list(actions), dim=-1)
        noisy = (cat + expl_amount * noise[0].to(cat.device)).clamp(-1.0, 1.0)
        return [torch.where(expl_amount > 0.0, noisy, cat)]
    out = []
    for act, (category, u) in zip(actions, noise):
        rand = F.one_hot(category.to(device=act.device, dtype=torch.long), act.shape[-1]).to(act.dtype)
        out.append(torch.where(u.to(act.device) < expl_amount, rand, act))
    return out


# ---------------------------------------------------------------------------
# encoders / decoders
# ---------------------------------------------------------------------------


def _stage_channels(channels_multiplier: int, stages: int) -> List[int]:
    return [(2**i) * int(channels_multiplier) for i in range(stages)]


class CNNEncoder(nn.Module):
    """``stages`` k=4/s=2/p=1 conv stages (each halves the image), channels
    ``[1, 2, 4, ...] × multiplier``, flattened in NHWC order. Input
    ``obs[k]`` is ``[..., C, H, W]``."""

    def __init__(self, keys, in_channels, channels_multiplier, stages=4, layer_norm=True, activation="silu",
                 device=None, dtype=None):
        super().__init__()
        self.keys = list(keys)
        self.cnn = CNN(
            in_channels,
            _stage_channels(channels_multiplier, stages),
            kernel_sizes=4,
            strides=2,
            paddings=1,
            activation=activation,
            layer_norm=layer_norm,
            norm_eps=_EPS,
            bias=not layer_norm,
            flatten=True,
            device=device,
            dtype=dtype,
        )

    def forward(self, obs: Mapping[str, torch.Tensor]) -> torch.Tensor:
        return self.cnn(torch.cat([obs[k] for k in self.keys], dim=-3))


class MLPEncoder(nn.Module):
    """Vector encoder: symlog of the concatenated keys, then ``mlp_layers``
    dense blocks."""

    def __init__(self, keys, input_dim, mlp_layers=4, dense_units=512, layer_norm=True, activation="silu",
                 device=None, dtype=None):
        super().__init__()
        self.keys = list(keys)
        self.mlp = MLP(
            input_dim, [dense_units] * mlp_layers, activation=activation, layer_norm=layer_norm, norm_eps=_EPS,
            bias=not layer_norm, device=device, dtype=dtype,
        )

    def forward(self, obs: Mapping[str, torch.Tensor]) -> torch.Tensor:
        return self.mlp(symlog(torch.cat([obs[k] for k in self.keys], dim=-1)))


def encoder_output_dim(has_cnn: bool, has_mlp: bool, image_size: Tuple[int, int], channels_multiplier: int,
                       stages: int, dense_units: int) -> int:
    """The encoders' joint width: the CNN's flat ``(H/2^s)·(W/2^s)·C_last``
    plus the MLP's ``dense_units``."""
    width = 0
    if has_cnn:
        width += (image_size[0] >> stages) * (image_size[1] >> stages) * int(channels_multiplier) * 2 ** (stages - 1)
    if has_mlp:
        width += int(dense_units)
    return width


class CNNDecoder(nn.Module):
    """Pixel decoder: a Linear projection of the latent to the last encoder
    stage's ``[C, H/2^s, W/2^s]`` map (channel-first order), transposed-conv
    stages back up (activation after each), and a last transposed conv with
    a bias to ``sum(output_channels)`` channels; the output is shifted by
    +0.5."""

    def __init__(self, output_channels, channels_multiplier, stages, image_size, latent_size, layer_norm=True,
                 activation="silu", device=None, dtype=None):
        super().__init__()
        top_c = (2 ** (stages - 1)) * int(channels_multiplier)
        base = int(image_size[0]) // (2**stages)
        self.map_shape = (top_c, base, base)
        self.linear = Linear(latent_size, top_c * base * base, device=device, dtype=dtype)
        hidden = [(2**i) * int(channels_multiplier) for i in reversed(range(stages - 1))]
        self.decnn = None
        if hidden:
            self.decnn = DeCNN(
                top_c, hidden, kernel_sizes=4, strides=2, paddings=1, activation=activation,
                layer_norm=layer_norm, norm_eps=_EPS, bias=not layer_norm, final_activation=activation, device=device,
                dtype=dtype,
            )
        self.head = DeCNN(
            hidden[-1] if hidden else top_c, [sum(int(c) for c in output_channels)], kernel_sizes=4, strides=2,
            paddings=1, activation="identity", layer_norm=False, bias=True, device=device, dtype=dtype,
        )

    def forward(self, latent: torch.Tensor) -> torch.Tensor:
        x = self.linear(latent)
        x = x.reshape(x.shape[:-1] + self.map_shape)
        if self.decnn is not None:
            x = self.decnn(x)
        return self.head(x) + 0.5


class MLPDecoder(nn.Module):
    """Vector decoder: a dense trunk and one Linear head per key."""

    def __init__(self, keys, output_dims, latent_size, mlp_layers=4, dense_units=512, layer_norm=True,
                 activation="silu", device=None, dtype=None):
        super().__init__()
        self.keys = list(keys)
        self.mlp = MLP(latent_size, [dense_units] * mlp_layers, activation=activation, layer_norm=layer_norm,
                       norm_eps=_EPS, bias=not layer_norm, device=device, dtype=dtype)
        self.heads = nn.ModuleDict(
            {k: Linear(dense_units, int(d), device=device, dtype=dtype) for k, d in zip(keys, output_dims)}
        )

    def forward(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.mlp(latent)
        return {k: self.heads[k](x).float() for k in self.keys}


class MLPWithHead(nn.Module):
    """Dense trunk and one Linear head: the reward, continue and critic heads."""

    def __init__(self, input_dim, output_dim, mlp_layers, dense_units, layer_norm=True, activation="silu",
                 device=None, dtype=None):
        super().__init__()
        self.mlp = MLP(input_dim, [dense_units] * mlp_layers, activation=activation, layer_norm=layer_norm,
                       norm_eps=_EPS, bias=not layer_norm, device=device, dtype=dtype)
        self.head = Linear(dense_units, output_dim, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.mlp(x)).float()


# ---------------------------------------------------------------------------
# recurrent model / RSSM
# ---------------------------------------------------------------------------


class RecurrentModel(nn.Module):
    """Dense pre-layer, then the LayerNorm-GRU cell (no bias, LayerNorm on,
    eps 1e-3 as in the JAX module)."""

    def __init__(self, input_size, recurrent_state_size, dense_units, layer_norm=True, activation="silu",
                 device=None, dtype=None):
        super().__init__()
        self.mlp = MLP(input_size, [dense_units], activation=activation, layer_norm=layer_norm, norm_eps=_EPS,
                       bias=not layer_norm, device=device, dtype=dtype)
        self.gru = LayerNormGRUCell(
            dense_units, recurrent_state_size, bias=False, layer_norm=True, norm_eps=_EPS, device=device, dtype=dtype
        )

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        return self.gru(self.mlp(x), h)


class _StochasticModel(nn.Module):
    """Dense trunk plus a logits head: the transition (prior) model."""

    def __init__(self, input_size, hidden_size, stoch_size, layer_norm=True, activation="silu", device=None,
                 dtype=None):
        super().__init__()
        self.mlp = MLP(input_size, [hidden_size], activation=activation, layer_norm=layer_norm, norm_eps=_EPS,
                       bias=not layer_norm, device=device, dtype=dtype)
        self.head = Linear(hidden_size, stoch_size, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.mlp(x)).float()


class _RepresentationModel(nn.Module):
    """The posterior model over ``[h, embed]``: one trunk Linear (the JAX
    ``trunk_kernel``, ``[H+E] → hidden``), LayerNorm, activation and the
    logits head. Its embed half is applied apart (:meth:`project_embed`), so
    that training runs it once over the whole sequence and the time loop
    adds only ``h·W_h``."""

    def __init__(self, h_size, embed_size, hidden_size, stoch_size, layer_norm=True, activation="silu", device=None,
                 dtype=None):
        super().__init__()
        self.h_size = int(h_size)
        self.dtype = dtype
        self.trunk = nn.Linear(self.h_size + int(embed_size), hidden_size, bias=not layer_norm, device=device)
        self.trunk_ln = FastLayerNorm(hidden_size, eps=_EPS, device=device, dtype=dtype) if layer_norm else None
        self.act = resolve_activation(activation)
        self.head = Linear(hidden_size, stoch_size, device=device, dtype=dtype)

    def _cast(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.dtype is None else x.to(self.dtype)

    def project_embed(self, embed: torch.Tensor) -> torch.Tensor:
        return F.linear(self._cast(embed), self._cast(self.trunk.weight[:, self.h_size:]))

    def from_projected(self, h: torch.Tensor, embed_proj: torch.Tensor) -> torch.Tensor:
        bias = None if self.trunk.bias is None else self._cast(self.trunk.bias)
        x = F.linear(self._cast(h), self._cast(self.trunk.weight[:, : self.h_size]), bias) + self._cast(embed_proj)
        if self.trunk_ln is not None:
            x = self.trunk_ln(x)
        return self.head(self.act(x)).float()


def uniform_mix(logits: torch.Tensor, discrete: int, unimix: float) -> torch.Tensor:
    """The 1% uniform mix on flat categorical logits ``[..., S*D]``: softmax
    over each D, ``(1−u)·p + u/D``, log; same flat shape."""
    if unimix <= 0.0:
        return logits
    shape = logits.shape
    probs = F.softmax(logits.reshape(shape[:-1] + (-1, discrete)), dim=-1)
    return torch.log((1.0 - unimix) * probs + unimix / discrete).reshape(shape)


def compute_stochastic_state(
    logits: torch.Tensor,
    discrete: int,
    generator: Optional[torch.Generator] = None,
    sample: bool = True,
    gumbel: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Straight-through sample (or mode) of the categorical latent. ``logits``
    flat ``[..., S*D]`` → flat state ``[..., S*D]``. ``gumbel`` ``[..., S, D]``
    is pre-drawn Gumbel(0,1) noise; without it the noise comes from
    ``generator``."""
    shape = logits.shape
    logits = logits.reshape(shape[:-1] + (-1, discrete))
    if sample and gumbel is not None:
        one = F.one_hot((logits + gumbel).argmax(dim=-1), discrete).to(logits.dtype)
        probs = F.softmax(logits, dim=-1)
        return (one + probs - probs.detach()).reshape(shape)
    dist = OneHotCategoricalStraightThrough(logits=logits)
    state = dist.rsample(generator) if sample else dist.mode
    return state.reshape(shape)


class RSSM(nn.Module):
    """Discrete-latent RSSM, single-step methods; every categorical gets the
    ``unimix`` uniform mix. The stochastic state is carried flat
    ``[..., S*D]``."""

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
        layer_norm: bool = True,
        unimix: float = 0.01,
        activation: Any = "silu",
        device=None,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.discrete_size = int(discrete_size)
        self.unimix = float(unimix)
        stoch = int(stochastic_size) * self.discrete_size
        H = int(recurrent_state_size)
        self.recurrent_model = RecurrentModel(
            stoch + int(action_dim), H, dense_units, layer_norm, activation, device, dtype
        )
        self.representation_model = _RepresentationModel(
            H, embed_size, representation_hidden_size or hidden_size, stoch, layer_norm, activation, device, dtype
        )
        self.transition_model = _StochasticModel(H, hidden_size, stoch, layer_norm, activation, device, dtype)

    def _transition(self, recurrent_out, generator=None, sample_state=True, gumbel=None):
        logits = self.prior_logits(recurrent_out)
        return logits, compute_stochastic_state(
            logits, self.discrete_size, generator, sample=sample_state, gumbel=gumbel
        )

    def project_embed(self, embedded_obs: torch.Tensor) -> torch.Tensor:
        """The embed half of the posterior trunk, batchable over any leading shape."""
        return self.representation_model.project_embed(embedded_obs)

    def _representation_projected(self, recurrent_state, embed_proj, generator=None, gumbel=None):
        logits = uniform_mix(
            self.representation_model.from_projected(recurrent_state, embed_proj), self.discrete_size, self.unimix
        )
        return logits, compute_stochastic_state(logits, self.discrete_size, generator, gumbel=gumbel)

    def _representation(self, recurrent_state, embedded_obs, generator=None, gumbel=None):
        return self._representation_projected(recurrent_state, self.project_embed(embedded_obs), generator, gumbel)

    def initial_posterior(self, recurrent_state: torch.Tensor) -> torch.Tensor:
        """The prior's mode at ``recurrent_state``: the stochastic state an
        episode starts from (at a zero recurrent state)."""
        return self._transition(recurrent_state, sample_state=False)[1]

    def dynamic_posterior(self, posterior, recurrent_state, action, embed_proj, is_first, init_posterior,
                          gumbel=None, generator=None):
        """One posterior step of training: an ``is_first`` row starts from a
        zero action and recurrent state and from ``init_posterior``, then
        recurrent → posterior. Returns ``(recurrent_state, posterior,
        posterior_logits)``; the prior logits are batched afterwards
        (:meth:`prior_logits`)."""
        keep = 1.0 - is_first
        action = keep * action
        recurrent_state = keep * recurrent_state
        posterior = keep * posterior + is_first * init_posterior
        recurrent_state = self.recurrent_model(torch.cat([posterior, action], dim=-1), recurrent_state)
        posterior_logits, posterior = self._representation_projected(recurrent_state, embed_proj, generator, gumbel)
        return recurrent_state, posterior, posterior_logits

    def prior_logits(self, recurrent_states: torch.Tensor) -> torch.Tensor:
        """Uniform-mixed transition logits over any leading shape."""
        return uniform_mix(self.transition_model(recurrent_states), self.discrete_size, self.unimix)

    def imagination(self, prior, recurrent_state, actions, gumbel=None, generator=None):
        """One prior step in imagination: returns ``(prior, recurrent_state)``."""
        recurrent_state = self.recurrent_model(torch.cat([prior, actions], dim=-1), recurrent_state)
        _, imagined_prior = self._transition(recurrent_state, generator, gumbel=gumbel)
        return imagined_prior, recurrent_state


class WorldModel(nn.Module):
    """Encoders plus the RSSM (what the player runs), and with ``training``
    the decoders and the reward (``reward_bins`` two-hot logits) and
    continue heads."""

    def __init__(
        self,
        cnn_keys: Sequence[str],
        mlp_keys: Sequence[str],
        cnn_channels: Sequence[int],
        mlp_dims: Sequence[int],
        image_size: Tuple[int, int],
        channels_multiplier: int,
        stages: int,
        encoder_mlp_layers: int,
        dense_units: int,
        recurrent_state_size: int,
        stochastic_size: int,
        discrete_size: int,
        hidden_size: int,
        action_dim: int,
        representation_hidden_size: Optional[int] = None,
        layer_norm: bool = True,
        unimix: float = 0.01,
        cnn_act: Any = "silu",
        dense_act: Any = "silu",
        training: bool = False,
        decoder_mlp_layers: int = 4,
        reward_bins: int = 255,
        reward_mlp_layers: int = 4,
        reward_dense_units: int = 512,
        continue_mlp_layers: int = 4,
        continue_dense_units: int = 512,
        device=None,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.cnn_keys, self.mlp_keys = list(cnn_keys), list(mlp_keys)
        self.cnn_channels = [int(c) for c in cnn_channels]
        self.cnn_encoder = self.mlp_encoder = None
        if self.cnn_keys:
            self.cnn_encoder = CNNEncoder(
                self.cnn_keys, sum(self.cnn_channels), channels_multiplier, stages, layer_norm, cnn_act, device, dtype
            )
        if self.mlp_keys:
            self.mlp_encoder = MLPEncoder(
                self.mlp_keys, sum(int(d) for d in mlp_dims), encoder_mlp_layers, dense_units, layer_norm, dense_act,
                device, dtype,
            )
        embed = encoder_output_dim(
            bool(self.cnn_keys), bool(self.mlp_keys), image_size, channels_multiplier, stages, dense_units
        )
        self.rssm = RSSM(
            recurrent_state_size, stochastic_size, discrete_size, dense_units, hidden_size,
            embed_size=embed, action_dim=action_dim, representation_hidden_size=representation_hidden_size,
            layer_norm=layer_norm, unimix=unimix, activation=dense_act, device=device, dtype=dtype,
        )
        self.cnn_decoder = self.mlp_decoder = self.reward_model = self.continue_model = None
        if not training:
            return
        latent = int(stochastic_size) * int(discrete_size) + int(recurrent_state_size)
        if self.cnn_keys:
            self.cnn_decoder = CNNDecoder(
                self.cnn_channels, channels_multiplier, stages, image_size, latent, layer_norm, cnn_act, device, dtype
            )
        if self.mlp_keys:
            self.mlp_decoder = MLPDecoder(
                self.mlp_keys, mlp_dims, latent, decoder_mlp_layers, dense_units, layer_norm, dense_act, device, dtype
            )
        self.reward_model = MLPWithHead(
            latent, reward_bins, reward_mlp_layers, reward_dense_units, layer_norm, dense_act, device, dtype
        )
        self.continue_model = MLPWithHead(
            latent, 1, continue_mlp_layers, continue_dense_units, layer_norm, dense_act, device, dtype
        )

    def encode(self, obs: Mapping[str, torch.Tensor]) -> torch.Tensor:
        feats = []
        if self.cnn_encoder is not None:
            feats.append(self.cnn_encoder(obs))
        if self.mlp_encoder is not None:
            feats.append(self.mlp_encoder(obs))
        return torch.cat(feats, dim=-1) if len(feats) > 1 else feats[0]

    def initial_posterior(self, recurrent_state: torch.Tensor) -> torch.Tensor:
        return self.rssm.initial_posterior(recurrent_state)

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

    def reward_logits(self, latent: torch.Tensor) -> torch.Tensor:
        return self.reward_model(latent)

    def continue_logits(self, latent: torch.Tensor) -> torch.Tensor:
        return self.continue_model(latent)


# ---------------------------------------------------------------------------
# Hafner initialization and build
# ---------------------------------------------------------------------------

#: (module-name pattern, scale) of the uniform-initialized output heads, per
#: module (the JAX ``WM_UNIFORM_HEADS``, ``ACTOR_UNIFORM_HEADS`` and
#: ``CRITIC_UNIFORM_HEADS`` over the port's names); scale 0 means zeros
WM_UNIFORM_HEADS = (
    (r"^reward_model\.head$", 0.0),
    (r"^rssm\.transition_model\.head$", 1.0),
    (r"^rssm\.representation_model\.head$", 1.0),
    (r"^continue_model\.head$", 1.0),
    (r"^mlp_decoder\.heads\.", 1.0),
    (r"^cnn_decoder\.head\.", 1.0),
)
ACTOR_UNIFORM_HEADS = ((r"^heads\.\d+$", 1.0),)
#: the std of a standard normal cut at ±2
_TRUNC_STD_FACTOR = 0.87962566103423978
CRITIC_UNIFORM_HEADS = ((r"^head$", 0.0),)


def _fan_mean(m: nn.Module) -> float:
    """The mean of fan-in and fan-out of a layer's weight, as the JAX
    transform reads them from the flax layouts (a transposed conv's two
    channel axes are swapped, which leaves the mean as it is)."""
    w = m.weight
    if isinstance(m, LayerNormGRUCell):
        return (w.shape[0] + w.shape[1]) / 2.0  # [in, out], the JAX layout
    space = int(np.prod(w.shape[2:])) if w.dim() > 2 else 1
    return (w.shape[0] + w.shape[1]) * space / 2.0


def hafner_initialization(
    module: nn.Module, generator: torch.Generator, uniform_heads: Sequence[Tuple[str, float]] = ()
) -> None:
    """Every weight truncated-normal: a normal of std ``sqrt(1/mean(fan_in,
    fan_out)) / 0.8796`` cut at ±2 of its std, whose own std is then
    ``sqrt(1/mean fan)``; the weights of modules whose name matches a
    ``uniform_heads`` pattern ``U(−l, l)`` with ``l = sqrt(3·scale/mean
    fan)`` (zeros at scale 0); biases zero, LayerNorm affine ones and zeros
    (the JAX ``hafner_initialization``)."""
    compiled = [(re.compile(p), s) for p, s in uniform_heads]
    with torch.no_grad():
        for name, m in module.named_modules():
            if not isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d, LayerNormGRUCell)):
                continue
            denom = _fan_mean(m)
            scale = next((s for p, s in compiled if p.search(name)), None)
            if scale is None:
                std = math.sqrt(1.0 / denom) / _TRUNC_STD_FACTOR
                nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            elif scale == 0.0:
                m.weight.zero_()
            else:
                limit = math.sqrt(3.0 * scale / denom)
                m.weight.uniform_(-limit, limit, generator=generator)
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
    """World model and actor at ``cfg``'s widths, placed on ``device``, and
    (``algo.hafner_initialization``) Hafner-initialized from ``seed``
    (``cfg.seed`` when None). ``observation_space`` maps each key to a space
    with ``.shape`` or to a shape tuple.

    Returns ``(world_model, actor)`` in eval mode. With ``training=True`` the
    world model also has its decoders and heads, and the result is
    ``(world_model, actor, critic, target_critic)`` in train mode, the target
    a copy of the critic whose parameters take no gradient. Every module
    computes in the compute dtype of ``fabric.precision`` (f32 parameters
    either way)."""
    dev = resolve_device(device)
    dtype = compute_dtype_from_precision(cfg.get("fabric", {}).get("precision", "32-true"))
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
        stages=int(np.log2(screen)) - 2,
        encoder_mlp_layers=int(wm_cfg.encoder.mlp_layers),
        dense_units=int(wm_cfg.encoder.dense_units),
        recurrent_state_size=int(wm_cfg.recurrent_model.recurrent_state_size),
        stochastic_size=int(wm_cfg.stochastic_size),
        discrete_size=int(wm_cfg.discrete_size),
        hidden_size=int(wm_cfg.transition_model.hidden_size),
        action_dim=int(np.sum(actions_dim)),
        representation_hidden_size=int(wm_cfg.representation_model.hidden_size),
        layer_norm=bool(cfg.algo.layer_norm),
        unimix=float(cfg.algo.unimix),
        cnn_act=cfg.algo.cnn_act,
        dense_act=cfg.algo.dense_act,
        training=training,
        decoder_mlp_layers=int(wm_cfg.observation_model.mlp_layers),
        reward_bins=int(wm_cfg.reward_model.bins),
        reward_mlp_layers=int(wm_cfg.reward_model.mlp_layers),
        reward_dense_units=int(wm_cfg.reward_model.dense_units),
        continue_mlp_layers=int(wm_cfg.discount_model.mlp_layers),
        continue_dense_units=int(wm_cfg.discount_model.dense_units),
        dtype=dtype,
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
        dtype=dtype,
    )
    hafner = bool(cfg.algo.hafner_initialization)
    gen = torch.Generator().manual_seed(int(cfg.seed if seed is None else seed))
    if hafner:
        hafner_initialization(world_model, gen, WM_UNIFORM_HEADS)
        hafner_initialization(actor, gen, ACTOR_UNIFORM_HEADS)
    if not training:
        return world_model.to(dev).eval(), actor.to(dev).eval()
    critic_cfg = cfg.algo.critic
    critic = MLPWithHead(
        latent, int(critic_cfg.bins), int(critic_cfg.mlp_layers), int(critic_cfg.dense_units),
        bool(critic_cfg.layer_norm), critic_cfg.dense_act, dtype=dtype,
    )
    if hafner:
        hafner_initialization(critic, gen, CRITIC_UNIFORM_HEADS)
    target_critic = copy.deepcopy(critic).requires_grad_(False)
    return world_model.to(dev).train(), actor.to(dev).train(), critic.to(dev).train(), target_critic.to(dev).train()


def set_cell_impl(world_model: nn.Module, impl: str) -> None:
    """``"plain"`` runs the recurrent cell's plain PyTorch version on any
    device (to hold the CUDA kernel against it); ``"auto"`` restores the
    kernel on the card."""
    world_model.rssm.recurrent_model.gru.impl = impl


# ---------------------------------------------------------------------------
# player
# ---------------------------------------------------------------------------


def dreamer_player_fns(
    world_model: nn.Module,
    actor: Actor,
    cfg,
    actions_dim: Sequence[int],
    is_continuous: bool,
    *,
    unimix: float,
    initial_posterior: Optional[Callable[[torch.Tensor], torch.Tensor]],
    normalize: Callable[[Dict[str, torch.Tensor], Sequence[str]], Dict[str, torch.Tensor]],
    gaussian_posterior: bool = False,
    masked: bool = False,
) -> Dict[str, Any]:
    """The Dreamer player over an explicit state dict ``{"actions",
    "recurrent", "stochastic"}`` of ``[n, ...]`` tensors on the model's
    device: ``init_states``, ``reset_states``, ``greedy_action`` (serving,
    DreamerV2's test episode), ``exploration_action`` (acting in training,
    DreamerV3's test episode at zero exploration), and for
    :class:`ExplorationStep` ``explore``, ``draw_exploration_noise`` and
    ``normalize``. A fresh state has zero actions and recurrent state and
    the stochastic state ``initial_posterior(recurrent)`` (zeros when None);
    the actor's categoricals take the ``unimix`` mix. A continuous action is
    the float vector itself. The posterior's noise (``gumbel`` in the
    functions' arguments) is Gumbels ``[n, S, D]``, or with
    ``gaussian_posterior`` (DreamerV1's latent) standard normals ``[n, S]``.

    With ``masked`` (MineDojo's three heads), a step given ``masks`` (the
    env's ``mask_*`` observations) samples through
    :mod:`~sheeprl_tpu_torch.algos.dreamer_v3.minedojo_actor` (the uniform
    mix, then the masks; its exploration draw a ``(gumbel [n, dim], u [n,
    1])`` pair a head); a step given none acts as the unmasked player."""
    distribution = resolve_actor_distribution(cfg.distribution.get("type", "auto"), is_continuous)
    init_std, min_std = float(cfg.algo.actor.init_std), float(cfg.algo.actor.min_std)
    wm_cfg = cfg.algo.world_model
    rec_size = int(wm_cfg.recurrent_model.recurrent_state_size)
    stoch = int(wm_cfg.stochastic_size)
    posterior_shape = (stoch,) if gaussian_posterior else (stoch, int(wm_cfg.discrete_size))
    act_dim = int(np.sum(actions_dim))
    dims = [int(d) for d in actions_dim]
    heads = [act_dim] if is_continuous else dims
    device = next(world_model.parameters()).device

    @torch.no_grad()
    def init_states(n: int) -> Dict[str, torch.Tensor]:
        recurrent = torch.zeros((n, rec_size), device=device)
        stochastic = (
            torch.zeros((n, int(np.prod(posterior_shape))), device=device)
            if initial_posterior is None else initial_posterior(recurrent)
        )
        return {"actions": torch.zeros((n, act_dim), device=device), "recurrent": recurrent, "stochastic": stochastic}

    def reset_states(state: Dict[str, torch.Tensor], reset_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``mask·fresh + (1 − mask)·state`` per row, ``reset_mask`` ``[n, 1]``."""
        mask = reset_mask.to(device=device, dtype=torch.float32).reshape(-1, 1)
        fresh = init_states(state["recurrent"].shape[0])
        return {k: mask * fresh[k] + (1.0 - mask) * v for k, v in state.items()}

    def _policy(latent):
        return build_actor_dists(actor(latent), is_continuous, distribution, init_std, min_std, unimix)

    def _masked_actions(latent, masks, is_training, noise=None):
        from sheeprl_tpu_torch.algos.dreamer_v3.minedojo_actor import sample_minedojo_actions

        return sample_minedojo_actions(actor(latent), masks, unimix, is_training, noise)[0]

    @torch.inference_mode()
    def greedy_action(
        state: Dict[str, torch.Tensor],
        obs: Mapping[str, torch.Tensor],
        generator: Optional[torch.Generator] = None,
        gumbel: Optional[torch.Tensor] = None,
        action_noise: Optional[Sequence[torch.Tensor]] = None,
        masks: Optional[Mapping[str, torch.Tensor]] = None,
    ):
        """One greedy step: the posterior is still sampled (from ``gumbel``,
        its noise, or ``generator``), the action is the actor's mode, or
        for continuous actions the best of GREEDY_SAMPLES samples (their
        noise ``action_noise``, one ``[GREEDY_SAMPLES, n, A]`` tensor, or
        from ``generator``)."""
        embed = world_model.encode(obs)
        recurrent = world_model.recurrent_step(state["stochastic"], state["actions"], state["recurrent"])
        _, stochastic = world_model.representation(recurrent, embed, generator, gumbel)
        latent = torch.cat([stochastic, recurrent], dim=-1)
        if masked and masks is not None:
            actions = _masked_actions(latent, masks, is_training=False)
        else:
            noise = None if action_noise is None else [t.to(device) for t in action_noise]
            actions = sample_actor_actions(_policy(latent), is_continuous, generator, is_training=False, noise=noise)
        new_state = {"actions": torch.cat(actions, dim=-1), "recurrent": recurrent, "stochastic": stochastic}
        return actions, new_state

    def draw_exploration_noise(n: int, generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """One acting step's noise, in the order the step draws it: the
        posterior's (Gumbels ``[n, S, D]``, DreamerV1's standard normals ``[n,
        S]``), each action head's sampling noise
        (:func:`actor_noise`: Gumbels ``[n, dim]`` a categorical head, the
        continuous head's ``[n, A]``), then the exploration draw: per
        categorical head ``(uniform_category [n], u [n, 1])``, or one
        standard normal ``[n, A]`` for continuous actions."""
        if gaussian_posterior:
            gumbel = torch.randn((n,) + posterior_shape, generator=generator, device=device)
        else:
            gumbel = gumbel_noise((n,) + posterior_shape, generator, device)
        action_noise = [actor_noise(distribution, (n, d), generator, device) for d in heads]
        if is_continuous:
            expl = [torch.randn((n, act_dim), generator=generator, device=device)]
        elif masked:
            expl = [(gumbel_noise((n, d), generator, device), torch.rand((n, 1), generator=generator, device=device))
                    for d in dims]
        else:
            expl = [
                (torch.randint(0, d, (n,), generator=generator, device=device),
                 torch.rand((n, 1), generator=generator, device=device))
                for d in dims
            ]
        return {"gumbel": gumbel, "action_gumbels": action_noise, "expl_noise": expl}

    def explore(state, obs, expl_amount: torch.Tensor, gumbel, action_gumbels, expl_noise, masks=None):
        """The acting step over given noise and a device ``expl_amount``: no
        host branch, so that it replays from a CUDA graph
        (:func:`add_exploration_noise`: at ``expl_amount = 0`` the sampled
        action is kept)."""
        embed = world_model.encode(obs)
        recurrent = world_model.recurrent_step(state["stochastic"], state["actions"], state["recurrent"])
        _, stochastic = world_model.representation(recurrent, embed, None, gumbel)
        latent = torch.cat([stochastic, recurrent], dim=-1)
        if masked and masks is not None:
            from sheeprl_tpu_torch.algos.dreamer_v3.minedojo_actor import add_minedojo_exploration_noise

            actions = _masked_actions(latent, masks, True, noise=action_gumbels)
            noisy = add_minedojo_exploration_noise(actions, expl_amount, masks, expl_noise)
        else:
            actions = sample_actor_actions(_policy(latent), is_continuous, is_training=True, noise=action_gumbels)
            noisy = add_exploration_noise(actions, expl_amount, is_continuous, expl_noise)
        new_state = {"actions": torch.cat(noisy, dim=-1), "recurrent": recurrent, "stochastic": stochastic}
        return noisy, new_state

    @torch.inference_mode()
    def exploration_action(
        state: Dict[str, torch.Tensor],
        obs: Mapping[str, torch.Tensor],
        expl_amount: float,
        generator: Optional[torch.Generator] = None,
        gumbel: Optional[torch.Tensor] = None,
        action_gumbels: Optional[Sequence[torch.Tensor]] = None,
        expl_noise: Optional[Sequence[Any]] = None,
        masks: Optional[Mapping[str, torch.Tensor]] = None,
    ):
        """One acting step of training (the JAX ``exploration_action``): the
        posterior and each action head are sampled (from ``gumbel``, the
        posterior's noise, and ``action_gumbels``, each head's), then exploration
        noise is added (``add_exploration_noise``, its draw ``expl_noise``).
        Noise not given is drawn from ``generator``
        (:func:`draw_exploration_noise`'s order), the exploration draw at
        every ``expl_amount``. The carried action is the one taken."""
        n = state["recurrent"].shape[0]
        drawn = draw_exploration_noise(n, generator) if None in (gumbel, action_gumbels, expl_noise) else {}
        amount = torch.as_tensor(expl_amount, dtype=torch.float32).to(device)
        return explore(
            state, obs, amount,
            drawn["gumbel"] if gumbel is None else gumbel.to(device),
            drawn["action_gumbels"] if action_gumbels is None else [g.to(device) for g in action_gumbels],
            drawn["expl_noise"] if expl_noise is None else expl_noise,
            None if masks is None else {k: torch.as_tensor(v).to(device) for k, v in masks.items()},
        )

    return {
        "init_states": init_states,
        "reset_states": reset_states,
        "greedy_action": greedy_action,
        "exploration_action": exploration_action,
        "explore": explore,
        "draw_exploration_noise": draw_exploration_noise,
        "normalize": normalize,
    }


def is_minedojo(cfg) -> bool:
    """Whether the env is MineDojo's wrapper (by its ``_target_``, as the JAX package dispatches)."""
    return "minedojo" in str(cfg.env.wrapper.get("_target_", "") or "").lower()


def build_player_fns(
    world_model: WorldModel, actor: Actor, cfg, actions_dim: Sequence[int], is_continuous: bool
) -> Dict[str, Any]:
    """DreamerV3's player (:func:`dreamer_player_fns`): a fresh state's
    stochastic part is the prior's mode at a zero recurrent state, computed
    with the current weights; the actor's categoricals take
    ``algo.unimix``; pixels are scaled to [0, 1]; on MineDojo the steps that
    are given the env's masks sample through them."""
    return dreamer_player_fns(
        world_model, actor, cfg, actions_dim, is_continuous, unimix=float(cfg.algo.unimix),
        initial_posterior=world_model.initial_posterior, normalize=normalize_obs_tensors, masked=is_minedojo(cfg),
    )


class ExplorationStep:
    """The training loop's acting step at B = ``n``: ``reset_states`` with
    the envs that ended since the last step, then the exploration action, as
    one function over static buffers (the raw observation, the reset mask,
    ``expl_amount``, the noise and the player state, which it updates in
    place), replayed from a CUDA graph on the card
    (:class:`~sheeprl_tpu_torch.train.graphs.CapturedStep`). The graph reads
    the world model's and the actor's parameters where they are, so the
    optimizers' in-place updates reach it. Each call copies the observation
    and the mask in and draws the noise from ``generator`` (or copies the
    given noise) before the replay.

    With ``reset_in_step=False`` the step has no reset: the loop calls
    :meth:`reset` when envs end, so that a fresh state that depends on the
    weights (DreamerV3's) is made with the weights of that moment, before
    the next gradient step, as the JAX loop makes it. ``masks_example``
    (MineDojo's ``mask_*`` observations) makes the masks inputs of the step
    too: static buffers each call copies the env's masks into, like the
    observation."""

    def __init__(self, player_fns: Dict[str, Any], n: int, obs_example: Mapping[str, np.ndarray],
                 cnn_keys: Sequence[str], generator: Optional[torch.Generator], device, reset_in_step: bool = True,
                 masks_example: Optional[Mapping[str, np.ndarray]] = None):
        self.device = resolve_device(device)
        self._reset_in_step = bool(reset_in_step)
        self._fns = player_fns
        self._generator = generator
        self._cnn_keys = list(cnn_keys)
        self.n = int(n)
        self.state = player_fns["init_states"](self.n)
        self.obs = {k: torch.zeros(np.shape(v), dtype=torch.from_numpy(np.asarray(v)).dtype, device=self.device)
                    for k, v in obs_example.items()}
        self.masks = {k: torch.zeros(np.shape(v), dtype=torch.bool, device=self.device)
                      for k, v in (masks_example or {}).items()}
        self.reset_mask = torch.zeros((self.n, 1), dtype=torch.float32, device=self.device)
        self.expl_amount = torch.zeros((), dtype=torch.float32, device=self.device)
        self.noise = player_fns["draw_exploration_noise"](self.n, None)
        self.step = CapturedStep(self._body, self.device, name="act")

    @torch.no_grad()
    def _body(self) -> list:
        state = self._fns["reset_states"](self.state, self.reset_mask) if self._reset_in_step else self.state
        obs = self._fns["normalize"](self.obs, self._cnn_keys)
        actions, new_state = self._fns["explore"](
            state, obs, self.expl_amount, self.noise["gumbel"], self.noise["action_gumbels"], self.noise["expl_noise"],
            self.masks or None,
        )
        for k, v in new_state.items():
            self.state[k].copy_(v)
        return actions

    def _mask(self, reset_mask: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(reset_mask, dtype=np.float32).reshape(self.n, 1))

    @torch.no_grad()
    def reset(self, reset_mask: np.ndarray) -> None:
        """Reset the state rows where ``reset_mask`` ``[n, 1]`` is 1, now (eagerly)."""
        for k, v in self._fns["reset_states"](self.state, self._mask(reset_mask).to(self.device)).items():
            self.state[k].copy_(v)

    def __call__(self, obs: Mapping[str, np.ndarray], reset_mask: Optional[np.ndarray], expl_amount: float,
                 noise: Optional[Dict[str, Any]] = None, masks: Optional[Mapping[str, np.ndarray]] = None) -> list:
        """The actions (one ``[n, dim]`` tensor a head) for ``obs`` (and
        ``masks``, a step built with ``masks_example``), after resetting the
        state rows where ``reset_mask`` ``[n, 1]`` is 1 (None without
        ``reset_in_step``)."""
        for k, v in obs.items():
            self.obs[k].copy_(torch.from_numpy(np.ascontiguousarray(v)))
        for k, buf in self.masks.items():
            buf.copy_(torch.from_numpy(np.ascontiguousarray(masks[k], dtype=bool)))
        if self._reset_in_step:
            self.reset_mask.copy_(self._mask(reset_mask))
        self.expl_amount.fill_(float(expl_amount))
        drawn = noise if noise is not None else self._fns["draw_exploration_noise"](self.n, self._generator)
        for dst, src in zip(_flat(self.noise), _flat(drawn), strict=True):
            dst.copy_(src)
        add_rollout_burst(act_dispatches=1)
        return self.step()


def _flat(noise: Dict[str, Any]) -> list:
    expl = [t for item in noise["expl_noise"] for t in (item if isinstance(item, (tuple, list)) else (item,))]
    return [noise["gumbel"], *noise["action_gumbels"], *expl]

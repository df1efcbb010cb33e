"""PPO agent (counterpart of ``sheeprl_tpu/algos/ppo/agent.py``): the
actor-critic over dict observations and the policy-head math that the
rollout step, the update and the greedy test each use.

- :class:`PPOAgent`: a feature trunk (``NatureCNN`` over the CNN keys
  stacked on their channel axis, an MLP with a linear head over the MLP keys
  concatenated; both when both are set) shared by an actor backbone with one
  linear head per discrete sub-action (one ``(mean, log_std)`` head of
  ``2·Σdims`` for a Box) and an MLP critic.
- :func:`sample_actions` takes its noise as an input: a Gumbel tensor per
  discrete head (``jax.random.categorical`` is the argmax of the
  log-softmax plus ``gumbel(fold_in(key, i))``) or one standard normal for
  the continuous head (:func:`draw_noise` draws them from a generator).
- Actions are exchanged as the JAX package's buffer layout: one-hot per
  discrete sub-action, concatenated (raw floats for continuous); the env's
  actions are the indices (or the same floats).

Weights start as flax's defaults (LeCun-normal Dense and Conv kernels, zero
biases, unit LayerNorm scales; the LSTM's state kernels orthogonal), drawn
from an explicit ``torch.Generator`` (:func:`flax_init_`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sheeprl_tpu_torch.algos.sac.agent import lecun_normal_
from sheeprl_tpu_torch.distributions.distributions import gumbel_noise
from sheeprl_tpu_torch.models.models import MLP, Linear, LSTMCell, NatureCNN

__all__ = [
    "MLPHead",
    "PPOAgent",
    "build_agent",
    "draw_noise",
    "encoder_dims",
    "evaluate_actions",
    "flax_init_",
    "greedy_actions",
    "sample_actions",
]

_HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)
#: the std of a standard normal cut at ±2
_TRUNC_STD_FACTOR = 0.87962566103423978


def flax_init_(module: nn.Module, generator: Optional[torch.Generator]) -> nn.Module:
    """flax's default initializers over ``module``: LeCun-normal kernels cut
    at ±2 std for every Linear and Conv2d (a convolution's fan-in is
    ``in·kh·kw``), zero biases, and orthogonal state kernels for each
    :class:`LSTMCell` gate (``nn.OptimizedLSTMCell``'s
    ``recurrent_kernel_init``). LayerNorms keep their unit scale."""
    lecun_normal_(module, generator)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                std = math.sqrt(1.0 / m.weight[0].numel()) / _TRUNC_STD_FACTOR
                nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, LSTMCell):
                for g in "ifgo":
                    nn.init.orthogonal_(getattr(m, f"h{g}").weight, generator=generator)
    return module


class MLPHead(nn.Module):
    """The JAX ``MLP`` with ``output_dim``: hidden blocks (``mlp``), then a
    bare Linear (``head``) with no activation after it."""

    def __init__(self, input_dim: int, hidden_sizes: Sequence[int], output_dim: int, activation: str = "relu",
                 layer_norm: bool = False, device=None):
        super().__init__()
        self.mlp = MLP(input_dim, hidden_sizes, activation, layer_norm, device=device)
        self.head = Linear(self.mlp.output_dim, int(output_dim), device=device)
        self.output_dim = int(output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.mlp(x))


class Encoder(nn.Module):
    """The shared feature trunk: ``NatureCNN`` over the CNN keys stacked on
    their channel axis, an MLP with a head over the MLP keys, their outputs
    concatenated (CNN first) when both are set."""

    def __init__(self, cnn_keys: Sequence[str], mlp_keys: Sequence[str], in_channels: int, mlp_input_dim: int,
                 screen_size: int, cnn_features_dim: int, mlp_features_dim: int, dense_units: int, mlp_layers: int,
                 dense_act: str, layer_norm: bool, device=None):
        super().__init__()
        self.cnn_keys, self.mlp_keys = tuple(cnn_keys), tuple(mlp_keys)
        self.cnn_encoder = NatureCNN(in_channels, cnn_features_dim, screen_size, device=device) if cnn_keys else None
        self.mlp_encoder = (MLPHead(mlp_input_dim, (dense_units,) * mlp_layers, mlp_features_dim, dense_act, layer_norm,
                                    device=device) if mlp_keys else None)
        self.output_dim = (cnn_features_dim if cnn_keys else 0) + (mlp_features_dim if mlp_keys else 0)

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        feats = []
        if self.cnn_encoder is not None:
            feats.append(self.cnn_encoder(torch.cat([obs[k] for k in self.cnn_keys], dim=-3)))
        if self.mlp_encoder is not None:
            feats.append(self.mlp_encoder(torch.cat([obs[k] for k in self.mlp_keys], dim=-1)))
        return torch.cat(feats, dim=-1) if len(feats) > 1 else feats[0]


def actor_heads(actions_dim: Sequence[int], is_continuous: bool, in_dim: int, device=None) -> nn.ModuleList:
    """One Linear per discrete sub-action, or one ``2·Σdims`` head for a Box."""
    widths = [2 * int(sum(actions_dim))] if is_continuous else [int(d) for d in actions_dim]
    return nn.ModuleList([Linear(in_dim, w, device=device) for w in widths])


class PPOAgent(nn.Module):
    """``forward(obs) -> (pre_dist, values)``; ``pre_dist`` is the heads'
    outputs, a list. Observations are normalized floats (:func:`normalize_obs`)."""

    def __init__(
        self,
        actions_dim: Sequence[int],
        is_continuous: bool,
        cnn_keys: Sequence[str],
        mlp_keys: Sequence[str],
        in_channels: int,
        mlp_input_dim: int,
        screen_size: int = 64,
        cnn_features_dim: int = 512,
        mlp_features_dim: int = 64,
        encoder_dense_units: int = 64,
        encoder_mlp_layers: int = 2,
        encoder_dense_act: str = "relu",
        encoder_layer_norm: bool = False,
        actor_dense_units: int = 64,
        actor_mlp_layers: int = 2,
        actor_dense_act: str = "tanh",
        actor_layer_norm: bool = False,
        critic_dense_units: int = 64,
        critic_mlp_layers: int = 2,
        critic_dense_act: str = "tanh",
        critic_layer_norm: bool = False,
        device=None,
    ):
        super().__init__()
        self.actions_dim = tuple(int(d) for d in actions_dim)
        self.is_continuous = bool(is_continuous)
        self.encoder = Encoder(cnn_keys, mlp_keys, in_channels, mlp_input_dim, screen_size, cnn_features_dim,
                               mlp_features_dim, encoder_dense_units, encoder_mlp_layers, encoder_dense_act,
                               encoder_layer_norm, device=device)
        feat = self.encoder.output_dim
        self.critic = MLPHead(feat, (critic_dense_units,) * critic_mlp_layers, 1, critic_dense_act, critic_layer_norm,
                              device=device)
        self.actor_backbone = MLP(feat, (actor_dense_units,) * actor_mlp_layers, actor_dense_act, actor_layer_norm,
                                  device=device)
        self.actor_heads = actor_heads(self.actions_dim, self.is_continuous, self.actor_backbone.output_dim, device)

    def pre_dist(self, obs: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        out = self.actor_backbone(self.encoder(obs))
        return [head(out) for head in self.actor_heads]

    def forward(self, obs: Dict[str, torch.Tensor]) -> Tuple[List[torch.Tensor], torch.Tensor]:
        feat = self.encoder(obs)
        out = self.actor_backbone(feat)
        return [head(out) for head in self.actor_heads], self.critic(feat)

    def get_value(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.critic(self.encoder(obs))


# ---------------------------------------------------------------------------
# the policy-head math
# ---------------------------------------------------------------------------


def draw_noise(actions_dim: Sequence[int], is_continuous: bool, lead: Tuple[int, ...],
               generator: Optional[torch.Generator], device) -> List[torch.Tensor]:
    """The noise of one sample of ``lead`` rows: Gumbels ``[*lead, dim]``
    per discrete head, or one standard normal ``[*lead, Σdims]``."""
    if is_continuous:
        return [torch.randn(tuple(lead) + (int(sum(actions_dim)),), generator=generator, device=device)]
    return [gumbel_noise(tuple(lead) + (int(d),), generator, device=device) for d in actions_dim]


def _normal_log_prob(x: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    return -((x - mean) ** 2) / (2 * std**2) - torch.log(std) - _HALF_LOG_2PI


def sample_actions(pre_dist: Sequence[torch.Tensor], is_continuous: bool,
                   noise: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(stored_actions, env_actions, logprob[..., 1])`` at the given noise:
    ``mean + std·eps`` for a Box (the env's actions are the same floats);
    for discrete heads the argmax of ``log_softmax + gumbel`` per head, the
    stored actions its one-hots concatenated, the env's the indices
    (int64 ``[..., heads]``)."""
    if is_continuous:
        mean, log_std = pre_dist[0].chunk(2, dim=-1)
        std = torch.exp(log_std)
        actions = mean + std * noise[0]
        logprob = _normal_log_prob(actions, mean, std).sum(dim=-1, keepdim=True)
        return actions, actions, logprob
    onehots, idxs, lps = [], [], []
    for logits, g in zip(pre_dist, noise):
        lp = F.log_softmax(logits, dim=-1)
        idx = torch.argmax(g + lp, dim=-1, keepdim=True)
        onehots.append(torch.zeros_like(lp).scatter_(-1, idx, 1.0))
        idxs.append(idx)
        lps.append(torch.gather(lp, -1, idx))
    return torch.cat(onehots, -1), torch.cat(idxs, -1), torch.cat(lps, -1).sum(dim=-1, keepdim=True)


def evaluate_actions(pre_dist: Sequence[torch.Tensor], actions: torch.Tensor, actions_dim: Sequence[int],
                     is_continuous: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Log-prob and entropy of stored actions: ``(logprob[..., 1], entropy[..., 1])``."""
    if is_continuous:
        mean, log_std = pre_dist[0].chunk(2, dim=-1)
        std = torch.exp(log_std)
        logprob = _normal_log_prob(actions, mean, std).sum(dim=-1, keepdim=True)
        entropy = (0.5 + _HALF_LOG_2PI + log_std).sum(dim=-1, keepdim=True)
        return logprob, entropy
    lps, ents = [], []
    for logits, act in zip(pre_dist, actions.split([int(d) for d in actions_dim], dim=-1)):
        lp = F.log_softmax(logits, dim=-1)
        lps.append(torch.sum(act * lp, dim=-1, keepdim=True))
        ents.append(-torch.sum(torch.exp(lp) * lp, dim=-1, keepdim=True))
    return torch.cat(lps, -1).sum(dim=-1, keepdim=True), torch.cat(ents, -1).sum(dim=-1, keepdim=True)


def greedy_actions(pre_dist: Sequence[torch.Tensor], is_continuous: bool) -> torch.Tensor:
    """The mode in the env's format: the mean for a Box, each head's argmax
    (int64 ``[..., heads]``) otherwise."""
    if is_continuous:
        return pre_dist[0].chunk(2, dim=-1)[0]
    return torch.cat([torch.argmax(logits, dim=-1, keepdim=True) for logits in pre_dist], dim=-1)


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------


def encoder_dims(observation_space, cnn_keys: Sequence[str], mlp_keys: Sequence[str]) -> Tuple[int, int]:
    """``(in_channels, mlp_input_dim)``: the CNN keys' channels, a frame stack
    folded into them, and the MLP keys' flattened widths."""
    channels = sum(int(np.prod(observation_space[k].shape[:-2])) for k in cnn_keys)
    width = sum(int(np.prod(observation_space[k].shape)) for k in mlp_keys)
    return channels, width


def build_agent(cfg, actions_dim: Sequence[int], is_continuous: bool, cnn_keys: Sequence[str],
                mlp_keys: Sequence[str], observation_space, generator: Optional[torch.Generator] = None,
                device=None) -> PPOAgent:
    """The agent at ``cfg``'s widths, its weights drawn by :func:`flax_init_`
    on the CPU from ``generator``, then moved to ``device``."""
    enc, act, crit = cfg.algo.encoder, cfg.algo.actor, cfg.algo.critic
    channels, width = encoder_dims(observation_space, cnn_keys, mlp_keys)
    agent = PPOAgent(
        actions_dim, is_continuous, cnn_keys, mlp_keys, channels, width,
        screen_size=int(cfg.env.screen_size),
        cnn_features_dim=int(enc.cnn_features_dim), mlp_features_dim=int(enc.mlp_features_dim),
        encoder_dense_units=int(enc.dense_units), encoder_mlp_layers=int(enc.mlp_layers),
        encoder_dense_act=enc.dense_act, encoder_layer_norm=bool(enc.layer_norm),
        actor_dense_units=int(act.dense_units), actor_mlp_layers=int(act.mlp_layers),
        actor_dense_act=act.dense_act, actor_layer_norm=bool(act.layer_norm),
        critic_dense_units=int(crit.dense_units), critic_mlp_layers=int(crit.mlp_layers),
        critic_dense_act=crit.dense_act, critic_layer_norm=bool(crit.layer_norm),
    )
    flax_init_(agent, generator)
    return agent.to(device) if device is not None else agent

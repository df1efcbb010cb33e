"""SAC agent (counterpart of ``sheeprl_tpu/algos/sac/agent.py``): the
tanh-Gaussian actor, the critic ensemble with its parameters stacked along
a leading member axis, and the sampling math.

- :class:`SACActor`: a two-layer ReLU trunk and the ``(mean, log_std)``
  heads, the std ``exp(clip(log_std, -5, 2))``.
- :class:`CriticEnsemble`: ``n`` Q-networks of one architecture, each layer
  one batched product over the members (``weight [N, in, out]``, the JAX
  package's stacked Dense kernels), with DroQ's LayerNorm and dropout as
  options. Its dropout takes its masks as an argument: the caller draws
  them (outside a captured graph) or a parity test injects them.
- :func:`squash_sample`: the reparameterized tanh-Gaussian sample rescaled
  to the action bounds, with the change-of-variable log-prob, in the JAX
  function's order of operations; its standard normal ``eps`` is an input.

Weights start as flax's defaults (LeCun-normal kernels, zero biases, unit
LayerNorm scales), drawn from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from sheeprl_tpu_torch.models.models import MLP, Linear
from sheeprl_tpu_torch.models.norm import fast_layer_norm

__all__ = [
    "LOG_STD_MAX",
    "LOG_STD_MIN",
    "CriticEnsemble",
    "SACActor",
    "action_bounds",
    "build_agent_state",
    "greedy_action",
    "lecun_normal_",
    "squash_sample",
]

LOG_STD_MAX = 2.0
LOG_STD_MIN = -5.0
#: the std of a standard normal cut at ±2
_TRUNC_STD_FACTOR = 0.87962566103423978
_HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)


def lecun_normal_(module: nn.Module, generator: Optional[torch.Generator]) -> nn.Module:
    """flax's default Dense init on every linear layer of ``module``: a normal
    of std ``sqrt(1/fan_in) / 0.8796`` cut at ±2 of its std, zero biases.
    A stacked weight ``[N, in, out]`` takes ``fan_in = in``."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, StackedLinear)):
                fan_in = m.weight.shape[1]
                std = math.sqrt(1.0 / fan_in) / _TRUNC_STD_FACTOR
                nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
    return module


class SACActor(nn.Module):
    """MLP trunk → ``(mean, std)``; the log-std clipped to [-5, 2]."""

    def __init__(self, obs_dim: int, action_dim: int, hidden_size: int = 256, device=None):
        super().__init__()
        self.mlp = MLP(obs_dim, (hidden_size, hidden_size), "relu", device=device)
        self.mean = Linear(hidden_size, action_dim, device=device)
        self.log_std = Linear(hidden_size, action_dim, device=device)

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.mlp(obs)
        std = torch.exp(torch.clamp(self.log_std(x), LOG_STD_MIN, LOG_STD_MAX))
        return self.mean(x), std


class StackedLinear(nn.Module):
    """N linear layers of one shape: ``weight [N, in, out]``, ``bias [N, out]``."""

    def __init__(self, n: int, in_dim: int, out_dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((n, in_dim, out_dim), device=device))
        self.bias = nn.Parameter(torch.zeros((n, out_dim), device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.baddbmm(self.bias[:, None, :], x, self.weight)


class StackedLayerNorm(nn.Module):
    """N LayerNorms over the last axis of ``[N, M, features]`` (``FastLayerNorm``'s
    contract: float32 statistics, the output in the input's and the
    parameters' promoted dtype)."""

    def __init__(self, n: int, features: int, eps: float, device=None):
        super().__init__()
        self.eps = float(eps)
        self.weight = nn.Parameter(torch.ones((n, features), device=device))
        self.bias = nn.Parameter(torch.zeros((n, features), device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = fast_layer_norm(x, self.weight[:, None, :], self.bias[:, None, :], self.eps)
        return out.to(torch.promote_types(x.dtype, self.weight.dtype))


class _StackedBlock(nn.Module):
    def __init__(self, n, in_dim, out_dim, layer_norm: bool, eps: float, device):
        super().__init__()
        self.linear = StackedLinear(n, in_dim, out_dim, device=device)
        self.norm = StackedLayerNorm(n, out_dim, eps, device=device) if layer_norm else None


class CriticEnsemble(nn.Module):
    """``n`` members of the JAX ``MLP``: Linear → [LayerNorm] → ReLU →
    [dropout] per hidden layer, then a linear head to one value. An input
    ``[M, in]`` shared by the members gives ``[n, M, out]`` through one
    batched product a layer.

    :meth:`forward` ``(features, action, masks=None) -> [M, n]`` is the JAX
    ``ensemble_q`` (``features`` and ``action`` concatenated); ``masks``
    (bool ``[layers, n, M, hidden]``) switches the dropout on, flax's
    ``where(mask, x / keep, 0)``."""

    def __init__(self, n: int, input_dim: int, hidden_sizes: Sequence[int], layer_norm: bool = False,
                 dropout: float = 0.0, norm_eps: float = 1e-5, device=None):
        super().__init__()
        self.n = int(n)
        self.input_dim = int(input_dim)
        self.dropout = float(dropout)
        dims = [self.input_dim] + [int(h) for h in hidden_sizes]
        self.blocks = nn.ModuleList(
            _StackedBlock(self.n, dims[i], dims[i + 1], layer_norm, norm_eps, device) for i in range(len(dims) - 1)
        )
        self.head = StackedLinear(self.n, dims[-1], 1, device=device)

    @property
    def hidden_sizes(self) -> Tuple[int, ...]:
        return tuple(int(b.linear.weight.shape[-1]) for b in self.blocks)

    def forward(self, features: torch.Tensor, action: torch.Tensor,
                masks: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = torch.cat([features, action], dim=-1)
        lead = x.shape[:-1]
        h = x.reshape(1, -1, self.input_dim).expand(self.n, -1, -1)
        keep = 1.0 - self.dropout
        for i, block in enumerate(self.blocks):
            h = block.linear(h)
            if block.norm is not None:
                h = block.norm(h)
            h = torch.relu(h)
            if masks is not None:
                h = torch.where(masks[i], h / keep, torch.zeros((), dtype=h.dtype, device=h.device))
        q = self.head(h)[..., 0]  # [n, M]
        return q.movedim(0, -1).reshape(*lead, self.n)


def _normal_log_prob(x: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    return -((x - mean) ** 2) / (2 * std**2) - torch.log(std) - _HALF_LOG_2PI


def squash_sample(mean: torch.Tensor, std: torch.Tensor, eps: torch.Tensor, action_scale: torch.Tensor,
                  action_bias: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(action, log_prob [.., 1])``: ``x = mean + std·eps``, ``y = tanh(x)``,
    the action ``y·scale + bias`` and the Gaussian log-prob of ``x`` less
    ``log(scale·(1 − y²) + 1e-6)``, summed over the action dims."""
    x_t = mean + std * eps
    y_t = torch.tanh(x_t)
    action = y_t * action_scale + action_bias
    log_prob = _normal_log_prob(x_t, mean, std)
    log_prob = log_prob - torch.log(action_scale * (1.0 - y_t**2) + 1e-6)
    return action, log_prob.sum(-1, keepdim=True)


def greedy_action(mean: torch.Tensor, action_scale: torch.Tensor, action_bias: torch.Tensor) -> torch.Tensor:
    """The deterministic action ``tanh(mean)·scale + bias``."""
    return torch.tanh(mean) * action_scale + action_bias


def action_bounds(action_space) -> Tuple[np.ndarray, np.ndarray]:
    """``(scale, bias)`` from the action bounds; unbounded dims fall back to
    the tanh range (scale 1, bias 0)."""
    low = np.asarray(action_space.low, np.float32).reshape(-1)
    high = np.asarray(action_space.high, np.float32).reshape(-1)
    unbounded = ~(np.isfinite(low) & np.isfinite(high))
    low = np.where(unbounded, -1.0, low)
    high = np.where(unbounded, 1.0, high)
    return ((high - low) / 2.0).astype(np.float32), ((high + low) / 2.0).astype(np.float32)


def build_agent_state(obs_dim: int, act_dim: int, actor_hidden: int, critic_hidden: int, n_critics: int,
                      alpha: float, generator: Optional[torch.Generator], device=None, critic_layer_norm=False,
                      critic_dropout: float = 0.0) -> dict:
    """The agent's modules (the JAX ``build_agent_state`` tree): the actor,
    the critics, their target (a copy) and ``log_alpha`` (shape ``[1]``),
    each initialized from ``generator`` on the CPU and moved to ``device``."""
    actor = lecun_normal_(SACActor(obs_dim, act_dim, actor_hidden), generator)
    critics = lecun_normal_(
        CriticEnsemble(n_critics, obs_dim + act_dim, (critic_hidden, critic_hidden), critic_layer_norm,
                       critic_dropout),
        generator,
    )
    targets = CriticEnsemble(n_critics, obs_dim + act_dim, (critic_hidden, critic_hidden), critic_layer_norm,
                             critic_dropout)
    targets.load_state_dict(critics.state_dict())
    targets.requires_grad_(False)
    log_alpha = nn.Parameter(torch.log(torch.tensor([float(alpha)], dtype=torch.float32)))
    return {
        "actor": actor.to(device),
        "critics": critics.to(device),
        "target_critics": targets.to(device),
        "log_alpha": nn.Parameter(log_alpha.detach().to(device)),
    }

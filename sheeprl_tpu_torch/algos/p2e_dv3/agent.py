"""Plan2Explore on DreamerV3: the agent (counterpart of
``sheeprl_tpu/algos/p2e_dv3/agent.py``).

On top of DreamerV3's world model, actor and critic:

- an **ensemble** of N MLPs that each predict the next flat stochastic state
  from ``(posterior, recurrent, action)``. The N members' weights are stacked
  along a leading axis (``[N, in, out]``, the JAX package's stacked Dense
  kernels) and all members run as one batched product a layer
  (:class:`Ensemble`), not as N modules;
- an **exploration actor** of the task actor's architecture, with fresh
  weights;
- the **exploration critics** of ``algo.critics_exploration``, one two-hot
  critic and its EMA target each, keyed by name.

The DreamerV3 player serves either actor (``build_player_fns`` over the
world model and the actor that acts).
"""

from __future__ import annotations

import copy
import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from sheeprl_tpu_torch.algos.dreamer_v3.agent import (
    ACTOR_UNIFORM_HEADS,
    CRITIC_UNIFORM_HEADS,
    Actor,
    MLPWithHead,
    build_player_fns,
    hafner_initialization,
    resolve_actor_distribution,
    set_cell_impl,
)
from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent as dv3_build_agent
from sheeprl_tpu_torch.device import resolve_device
from sheeprl_tpu_torch.fabric import compute_dtype_from_precision
from sheeprl_tpu_torch.models.models import resolve_activation
from sheeprl_tpu_torch.models.norm import fast_layer_norm

__all__ = [
    "Ensemble",
    "StackedLayerNorm",
    "StackedLinear",
    "build_agent",
    "build_ensemble",
    "build_player_fns",
    "lecun_normal_initialization",
    "set_cell_impl",
]

#: the ensemble members' LayerNorm eps (the JAX ``EnsembleMember``'s, in both families)
ENSEMBLE_NORM_EPS = 1e-3
#: the std of a standard normal cut at ±2
_TRUNC_STD_FACTOR = 0.87962566103423978


class StackedLinear(nn.Module):
    """N linear layers of one shape: ``weight [N, in, out]`` (the JAX stacked
    kernel's layout) and ``bias [N, out]``. ``[N, M, in] → [N, M, out]`` in
    one batched product."""

    def __init__(self, n: int, in_dim: int, out_dim: int, bias: bool = True, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((n, in_dim, out_dim), device=device))
        self.bias = nn.Parameter(torch.zeros((n, out_dim), device=device)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bias is None:
            return torch.bmm(x, self.weight)
        return torch.baddbmm(self.bias[:, None, :], x, self.weight)


class StackedLayerNorm(nn.Module):
    """N LayerNorms over the last axis of ``[N, M, features]``,
    ``weight``/``bias`` ``[N, features]`` (``models.norm.fast_layer_norm``'s
    two-pass f32 statistics)."""

    def __init__(self, n: int, features: int, eps: float, device=None):
        super().__init__()
        self.eps = float(eps)
        self.weight = nn.Parameter(torch.ones((n, features), device=device))
        self.bias = nn.Parameter(torch.zeros((n, features), device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fast_layer_norm(x, self.weight[:, None, :], self.bias[:, None, :], self.eps)


class _StackedBlock(nn.Module):
    def __init__(self, n, in_dim, out_dim, layer_norm, device):
        super().__init__()
        self.linear = StackedLinear(n, in_dim, out_dim, bias=not layer_norm, device=device)
        self.norm = StackedLayerNorm(n, out_dim, ENSEMBLE_NORM_EPS, device=device) if layer_norm else None

    def forward(self, x):
        x = self.linear(x)
        return self.norm(x) if self.norm is not None else x


class _StackedMLP(nn.Module):
    def __init__(self, n, input_dim, hidden_sizes, layer_norm, device):
        super().__init__()
        dims = [int(input_dim)] + [int(h) for h in hidden_sizes]
        self.blocks = nn.ModuleList(
            _StackedBlock(n, dims[i], dims[i + 1], layer_norm, device) for i in range(len(hidden_sizes))
        )


class Ensemble(nn.Module):
    """``n`` next-state predictors, each the JAX ``EnsembleMember``: a dense
    trunk of ``mlp_layers × dense_units`` (Linear → [LayerNorm, eps 1e-3, no
    bias when normed] → activation) and a linear head to ``output_dim``. An
    input ``[..., input_dim]`` shared by every member gives ``[n, ...,
    output_dim]``; each layer is one batched product over the members."""

    def __init__(self, n: int, input_dim: int, output_dim: int, mlp_layers: int, dense_units: int,
                 layer_norm: bool = True, activation: str = "silu", device=None):
        super().__init__()
        self.n, self.input_dim, self.output_dim = int(n), int(input_dim), int(output_dim)
        self.act = resolve_activation(activation)
        self.mlp = _StackedMLP(self.n, input_dim, [dense_units] * int(mlp_layers), bool(layer_norm), device)
        width = int(dense_units) if int(mlp_layers) > 0 else self.input_dim
        self.head = StackedLinear(self.n, width, self.output_dim, bias=True, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        h = x.reshape(1, -1, self.input_dim).expand(self.n, -1, -1)
        for block in self.mlp.blocks:
            h = self.act(block(h))
        return self.head(h).reshape(self.n, *lead, self.output_dim)


def lecun_normal_initialization(ensemble: Ensemble, generator: torch.Generator) -> None:
    """Each member's weights as flax's default Dense init (LeCun normal: a
    normal of std ``sqrt(1/fan_in) / 0.8796`` cut at ±2 of its std), biases
    zero, LayerNorm affine ones and zeros."""
    with torch.no_grad():
        for m in ensemble.modules():
            if isinstance(m, StackedLinear):
                std = math.sqrt(1.0 / m.weight.shape[1]) / _TRUNC_STD_FACTOR
                nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()


def build_ensemble(cfg, actions_dim: Sequence[int], generator: torch.Generator, layer_norm_default: bool,
                   device=None, output_dim: Optional[int] = None) -> Ensemble:
    """``algo.ensembles`` at ``cfg``'s widths: ``n`` members from the latent
    and the action to the flat stochastic state (or to ``output_dim``:
    P2E-DV1's observation embedding), LeCun-normal initialized."""
    wm_cfg = cfg.algo.world_model
    stoch_flat = int(wm_cfg.stochastic_size) * int(wm_cfg.get("discrete_size", 1))
    latent = stoch_flat + int(wm_cfg.recurrent_model.recurrent_state_size)
    ens_cfg = cfg.algo.ensembles
    ensemble = Ensemble(
        int(ens_cfg.n), latent + int(np.sum(actions_dim)), stoch_flat if output_dim is None else int(output_dim),
        int(ens_cfg.mlp_layers), int(ens_cfg.dense_units), bool(ens_cfg.get("layer_norm", layer_norm_default)),
        ens_cfg.dense_act,
    )
    lecun_normal_initialization(ensemble, generator)
    return ensemble.to(resolve_device(device))


def build_agent(
    cfg,
    actions_dim: Sequence[int],
    is_continuous: bool,
    observation_space: Mapping[str, Any],
    seed: Optional[int] = None,
    device=None,
    training: bool = True,
) -> Tuple[Any, ...]:
    """The P2E-DV3 modules at ``cfg``'s widths on ``device``:
    ``(world_model, actor_task, critic_task, target_critic_task,
    actor_exploration, critics_exploration, ensembles)`` in train mode, with
    ``critics_exploration`` ``{name: {"module": critic, "target": copy}}``
    over ``algo.critics_exploration``. The DreamerV3 part is DreamerV3's
    ``build_agent`` from ``seed`` (``cfg.seed`` when None); the exploration
    actor and critics (Hafner-initialized under
    ``algo.hafner_initialization``) and the ensemble are drawn from a
    generator seeded ``seed + 1``. ``training=False`` is DreamerV3's serving
    build, ``(world_model, actor)``."""
    if not training:
        return dv3_build_agent(cfg, actions_dim, is_continuous, observation_space, seed=seed, device=device)
    dev = resolve_device(device)
    world_model, actor, critic, target_critic = dv3_build_agent(
        cfg, actions_dim, is_continuous, observation_space, seed=seed, device=dev, training=True
    )
    gen = torch.Generator().manual_seed(int(cfg.seed if seed is None else seed) + 1)
    hafner = bool(cfg.algo.hafner_initialization)
    # the exploration actor and critics compute in the run's precision, as the
    # task's; the ensemble takes no dtype and stays f32, as in JAX
    dtype = compute_dtype_from_precision(cfg.get("fabric", {}).get("precision", "32-true"))
    wm_cfg = cfg.algo.world_model
    latent = int(wm_cfg.stochastic_size) * int(wm_cfg.discrete_size) + int(wm_cfg.recurrent_model.recurrent_state_size)
    actor_exploration = Actor(
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
    if hafner:
        hafner_initialization(actor_exploration, gen, ACTOR_UNIFORM_HEADS)
    critic_cfg = cfg.algo.critic
    critics_exploration: Dict[str, Dict[str, nn.Module]] = {}
    for name in cfg.algo.critics_exploration.keys():
        module = MLPWithHead(
            latent, int(critic_cfg.bins), int(critic_cfg.mlp_layers), int(critic_cfg.dense_units),
            bool(critic_cfg.layer_norm), critic_cfg.dense_act, dtype=dtype,
        )
        if hafner:
            hafner_initialization(module, gen, CRITIC_UNIFORM_HEADS)
        target = copy.deepcopy(module).requires_grad_(False)
        critics_exploration[str(name)] = {"module": module.to(dev).train(), "target": target.to(dev).train()}
    ensembles = build_ensemble(cfg, actions_dim, gen, layer_norm_default=True, device=dev)
    return (
        world_model, actor, critic, target_critic, actor_exploration.to(dev).train(), critics_exploration,
        ensembles.train(),
    )


"""DroQ agent (counterpart of ``sheeprl_tpu/algos/droq/agent.py``): the
critic ensemble with Dropout and LayerNorm on every hidden layer
(https://arxiv.org/abs/2110.02034), stacked over its members as SAC's is.

Each member's dropout takes its own mask, ``[layers, n, batch, hidden]``
bools (:func:`draw_dropout_masks`, or a parity test's), as the JAX
ensemble draws one mask per member from one key each."""

from __future__ import annotations

from typing import Optional

import torch

from sheeprl_tpu_torch.algos.sac.agent import CriticEnsemble

__all__ = ["DROQCritic", "draw_dropout_masks"]


def DROQCritic(n: int, input_dim: int, hidden_size: int = 256, dropout: float = 0.0, device=None) -> CriticEnsemble:
    """``n`` Q(s, a) members: Linear → LayerNorm (eps 1e-5) → ReLU → Dropout,
    twice, then a linear head (``init_droq_ensemble``'s init is
    ``sac.agent.lecun_normal_``; its forward with masks is
    ``droq_ensemble_q``)."""
    return CriticEnsemble(n, input_dim, (hidden_size, hidden_size), layer_norm=True, dropout=dropout, device=device)


def draw_dropout_masks(critics: CriticEnsemble, batch: int, generator: Optional[torch.Generator], device,
                       lead=()) -> torch.Tensor:
    """Keep-masks ``[*lead, layers, n, batch, hidden]`` (Bernoulli at ``1 − dropout``)."""
    hidden = critics.hidden_sizes
    if len(set(hidden)) != 1:
        raise ValueError("the dropout masks are one tensor: every hidden layer must have one width")
    shape = tuple(lead) + (len(hidden), critics.n, int(batch), hidden[0])
    return torch.rand(shape, generator=generator, device=device) < (1.0 - critics.dropout)

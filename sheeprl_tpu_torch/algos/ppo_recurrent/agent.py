"""Recurrent PPO agent (counterpart of
``sheeprl_tpu/algos/ppo_recurrent/agent.py``): PPO's encoder, an optional
pre-RNN MLP over ``features ‖ prev_actions``, an LSTM over the sequence
whose carry is zeroed wherever ``is_first`` is set (the JAX
``_ResetLSTMCell`` inside ``nn.scan``), an optional post-RNN MLP, then
PPO's actor heads and critic on the recurrent output. Shapes are
sequence-first, ``[T, B, ...]``; the carry is ``(c, h)``, each ``[B, H]``.

The cell is flax's ``nn.OptimizedLSTMCell`` in PyTorch operations
(:class:`~sheeprl_tpu_torch.models.models.LSTMCell`): the JAX package
computes it outside any Pallas kernel. PPO's samplers, log-probs and
greedy actions apply to the heads' outputs as they are.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from sheeprl_tpu_torch.algos.ppo.agent import (  # noqa: F401  (the policy-head math is PPO's)
    Encoder,
    MLPHead,
    actor_heads,
    encoder_dims,
    evaluate_actions,
    flax_init_,
    greedy_actions,
    sample_actions,
)
from sheeprl_tpu_torch.models.models import MLP, LSTMCell

__all__ = ["RecurrentPPOAgent", "ResetLSTM", "build_agent"]

Carry = Tuple[torch.Tensor, torch.Tensor]


class ResetLSTM(nn.Module):
    """The LSTM over a sequence: before each step the carry is multiplied by
    ``1 − is_first`` (the JAX ``_ResetLSTMCell``), then one
    :class:`LSTMCell` step. ``forward(x [T, B, X], is_first [T, B, 1],
    (c, h)) -> (outputs [T, B, H], (c, h))``."""

    def __init__(self, input_size: int, hidden_size: int, device=None):
        super().__init__()
        self.cell = LSTMCell(input_size, hidden_size, device=device)
        self.hidden_size = int(hidden_size)

    def forward(self, x: torch.Tensor, is_first: torch.Tensor, carry: Carry) -> Tuple[torch.Tensor, Carry]:
        c, h = carry
        outs = []
        for t in range(x.shape[0]):
            keep = 1.0 - is_first[t]
            c, h = self.cell(x[t], (keep * c, keep * h))
            outs.append(h)
        return torch.stack(outs), (c, h)


class RecurrentPPOAgent(nn.Module):
    """``forward(obs, prev_actions, is_first, (c, h)) -> (pre_dist, values,
    (c, h))`` over ``[T, B, ...]`` inputs; observations normalized."""

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
        encoder_layer_norm: bool = True,
        rnn_hidden_size: int = 64,
        pre_rnn_apply: bool = False,
        pre_rnn_dense_units: int = 64,
        pre_rnn_act: str = "relu",
        pre_rnn_layer_norm: bool = True,
        post_rnn_apply: bool = False,
        post_rnn_dense_units: int = 64,
        post_rnn_act: str = "relu",
        post_rnn_layer_norm: bool = True,
        actor_dense_units: int = 128,
        actor_mlp_layers: int = 1,
        actor_dense_act: str = "relu",
        actor_layer_norm: bool = True,
        critic_dense_units: int = 128,
        critic_mlp_layers: int = 1,
        critic_dense_act: str = "relu",
        critic_layer_norm: bool = True,
        device=None,
    ):
        super().__init__()
        self.actions_dim = tuple(int(d) for d in actions_dim)
        self.is_continuous = bool(is_continuous)
        self.rnn_hidden_size = int(rnn_hidden_size)
        self.encoder = Encoder(cnn_keys, mlp_keys, in_channels, mlp_input_dim, screen_size, cnn_features_dim,
                               mlp_features_dim, encoder_dense_units, encoder_mlp_layers, encoder_dense_act,
                               encoder_layer_norm, device=device)
        width = self.encoder.output_dim + int(sum(self.actions_dim))
        self.pre_rnn = (MLP(width, (pre_rnn_dense_units,), pre_rnn_act, pre_rnn_layer_norm, device=device)
                        if pre_rnn_apply else None)
        if self.pre_rnn is not None:
            width = self.pre_rnn.output_dim
        self.rnn = ResetLSTM(width, self.rnn_hidden_size, device=device)
        self.post_rnn = (MLP(self.rnn_hidden_size, (post_rnn_dense_units,), post_rnn_act, post_rnn_layer_norm,
                             device=device) if post_rnn_apply else None)
        out = self.post_rnn.output_dim if self.post_rnn is not None else self.rnn_hidden_size
        self.actor_backbone = MLP(out, (actor_dense_units,) * actor_mlp_layers, actor_dense_act, actor_layer_norm,
                                  device=device)
        self.actor_heads = actor_heads(self.actions_dim, self.is_continuous, self.actor_backbone.output_dim, device)
        self.critic = MLPHead(out, (critic_dense_units,) * critic_mlp_layers, 1, critic_dense_act, critic_layer_norm,
                              device=device)

    def forward(self, obs: Dict[str, torch.Tensor], prev_actions: torch.Tensor, is_first: torch.Tensor,
                hc: Carry) -> Tuple[List[torch.Tensor], torch.Tensor, Carry]:
        x = torch.cat([self.encoder(obs), prev_actions], dim=-1)
        if self.pre_rnn is not None:
            x = self.pre_rnn(x)
        outs, hc = self.rnn(x, is_first, hc)
        if self.post_rnn is not None:
            outs = self.post_rnn(outs)
        trunk = self.actor_backbone(outs)
        return [head(trunk) for head in self.actor_heads], self.critic(outs), hc

    def initial_hc(self, batch: int, device=None) -> Carry:
        z = torch.zeros((int(batch), self.rnn_hidden_size), dtype=torch.float32, device=device)
        return z, z.clone()


def build_agent(cfg, actions_dim: Sequence[int], is_continuous: bool, cnn_keys: Sequence[str],
                mlp_keys: Sequence[str], observation_space, generator: Optional[torch.Generator] = None,
                device=None) -> RecurrentPPOAgent:
    """The agent at ``cfg``'s widths, its weights drawn by
    :func:`~sheeprl_tpu_torch.algos.ppo.agent.flax_init_` on the CPU from
    ``generator``, then moved to ``device``."""
    rnn, enc, act, crit = cfg.algo.rnn, cfg.algo.encoder, cfg.algo.actor, cfg.algo.critic
    channels, width = encoder_dims(observation_space, cnn_keys, mlp_keys)
    agent = RecurrentPPOAgent(
        actions_dim, is_continuous, cnn_keys, mlp_keys, channels, width,
        screen_size=int(cfg.env.screen_size),
        cnn_features_dim=int(enc.cnn_features_dim), mlp_features_dim=int(enc.mlp_features_dim),
        encoder_dense_units=int(enc.dense_units), encoder_mlp_layers=int(enc.mlp_layers),
        encoder_dense_act=enc.dense_act, encoder_layer_norm=bool(enc.layer_norm),
        rnn_hidden_size=int(rnn.lstm.hidden_size),
        pre_rnn_apply=bool(rnn.pre_rnn_mlp.apply), pre_rnn_dense_units=int(rnn.pre_rnn_mlp.dense_units),
        pre_rnn_act=rnn.pre_rnn_mlp.activation, pre_rnn_layer_norm=bool(rnn.pre_rnn_mlp.layer_norm),
        post_rnn_apply=bool(rnn.post_rnn_mlp.apply), post_rnn_dense_units=int(rnn.post_rnn_mlp.dense_units),
        post_rnn_act=rnn.post_rnn_mlp.activation, post_rnn_layer_norm=bool(rnn.post_rnn_mlp.layer_norm),
        actor_dense_units=int(act.dense_units), actor_mlp_layers=int(act.mlp_layers),
        actor_dense_act=act.dense_act, actor_layer_norm=bool(act.layer_norm),
        critic_dense_units=int(crit.dense_units), critic_mlp_layers=int(crit.mlp_layers),
        critic_dense_act=crit.dense_act, critic_layer_norm=bool(crit.layer_norm),
    )
    flax_init_(agent, generator)
    return agent.to(device) if device is not None else agent


def one_hot_actions(real: np.ndarray, actions_dim: Sequence[int], is_continuous: bool) -> np.ndarray:
    """The env's actions ``[n, heads]`` (or floats) as the stored layout:
    one-hots per head, concatenated (the floats as they are)."""
    real = np.asarray(real)
    n = real.shape[0]
    if is_continuous:
        return real.astype(np.float32).reshape(n, -1)
    return np.concatenate([np.eye(int(d), dtype=np.float32)[real.reshape(n, -1)[:, i].astype(np.int64)]
                           for i, d in enumerate(actions_dim)], axis=-1)

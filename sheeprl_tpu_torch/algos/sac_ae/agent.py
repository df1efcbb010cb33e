"""SAC-AE agent (counterpart of ``sheeprl_tpu/algos/sac_ae/agent.py``):
pixel SAC with a convolutional autoencoder.

- :class:`SACAEEncoder`: the CNN encoder (four VALID 3×3 convolutions of
  ``32·multiplier`` channels, strides 2, 1, 1, 1, ReLU; the map flattened in
  NHWC order, the JAX module's; then Dense → LayerNorm → tanh, with
  ``detach_conv`` stopping the gradient before the Dense) beside the MLP
  encoder of the vector keys.
- :class:`SACAEDecoder`: the CNN decoder (Dense back to the map, three
  stride-1 transposed convolutions and a stride-2 one, then one zero row
  and column at the bottom and the right: the JAX pad, not PyTorch's
  ``output_padding``) and the MLP decoder's per-key heads.
- :class:`SACAEActor`: the actor trunk, the log-std tanh-scaled into
  [-10, 2]; the twin Q-functions are SAC's stacked
  :class:`~sheeprl_tpu_torch.algos.sac.agent.CriticEnsemble`.
- :func:`sac_ae_weight_init`: orthogonal Dense kernels, delta-orthogonal
  convolutions (the centre tap orthogonal, the rest zero), zero biases,
  from an explicit generator; the stacked Q-function kernels keep flax's
  LeCun-normal default, as in JAX (its init skips 3-D kernels).
- :func:`preprocess_obs`: the ``bits``-bit pixel target in [-0.5, 0.5],
  with its dequantization noise an input.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sheeprl_tpu_torch.algos.sac.agent import CriticEnsemble, lecun_normal_
from sheeprl_tpu_torch.models.models import CNN, MLP, ConvTranspose2d, Linear
from sheeprl_tpu_torch.models.norm import FastLayerNorm

__all__ = [
    "LOG_STD_MAX",
    "LOG_STD_MIN",
    "SACAEActor",
    "SACAEDecoder",
    "SACAEEncoder",
    "build_agent",
    "conv_output_hw",
    "preprocess_obs",
    "sac_ae_weight_init",
]

LOG_STD_MAX = 2.0
LOG_STD_MIN = -10.0


def conv_output_hw(screen: int) -> int:
    """The map's side after the k=3, stride-[2, 1, 1, 1] encoder."""
    return (int(screen) - 3) // 2 + 1 - 2 * 3


class SACAECNNEncoder(nn.Module):
    def __init__(self, in_channels: int, features_dim: int, channels_multiplier: int, screen: int, device=None):
        super().__init__()
        c = 32 * int(channels_multiplier)
        self.cnn = CNN(in_channels, [c] * 4, 3, strides=[2, 1, 1, 1], paddings=0, activation="relu", flatten=True,
                       device=device)
        hw = conv_output_hw(screen)
        self.fc = Linear(c * hw * hw, features_dim, device=device)
        self.norm = FastLayerNorm(features_dim, eps=1e-6, device=device)

    def forward(self, x: torch.Tensor, detach_conv: bool = False) -> torch.Tensor:
        x = self.cnn(x)
        if detach_conv:
            x = x.detach()
        return torch.tanh(self.norm(self.fc(x)))


class SACAEMLPEncoder(nn.Module):
    def __init__(self, input_dim: int, dense_units: int, mlp_layers: int, activation, layer_norm: bool, device=None):
        super().__init__()
        self.mlp = MLP(input_dim, [dense_units] * mlp_layers, activation, layer_norm=layer_norm, device=device)

    def forward(self, x: torch.Tensor, detach_conv: bool = False) -> torch.Tensor:
        x = self.mlp(x)
        return x.detach() if detach_conv else x


class SACAEEncoder(nn.Module):
    """The CNN keys (concatenated on channels) and the MLP keys
    (concatenated), each through its encoder, the features concatenated."""

    def __init__(self, cnn_keys: Sequence[str], mlp_keys: Sequence[str], cnn_channels: int, mlp_dim: int,
                 features_dim: int, channels_multiplier: int, screen: int, dense_units: int, mlp_layers: int,
                 dense_act="relu", layer_norm: bool = False, device=None):
        super().__init__()
        self.cnn_keys, self.mlp_keys = list(cnn_keys), list(mlp_keys)
        self.cnn_encoder = (SACAECNNEncoder(cnn_channels, features_dim, channels_multiplier, screen, device)
                            if self.cnn_keys else None)
        self.mlp_encoder = (SACAEMLPEncoder(mlp_dim, dense_units, mlp_layers, dense_act, layer_norm, device)
                            if self.mlp_keys else None)
        self.output_dim = (features_dim if self.cnn_keys else 0) + (dense_units if self.mlp_keys else 0)

    def forward(self, obs: Mapping[str, torch.Tensor], detach_conv: bool = False) -> torch.Tensor:
        feats = []
        if self.cnn_encoder is not None:
            feats.append(self.cnn_encoder(torch.cat([obs[k] for k in self.cnn_keys], dim=-3), detach_conv))
        if self.mlp_encoder is not None:
            feats.append(self.mlp_encoder(torch.cat([obs[k] for k in self.mlp_keys], dim=-1), detach_conv))
        return torch.cat(feats, dim=-1) if len(feats) > 1 else feats[0]


class SACAECNNDecoder(nn.Module):
    def __init__(self, latent_dim: int, output_channels: int, conv_hw: int, channels_multiplier: int, device=None):
        super().__init__()
        self.c = 32 * int(channels_multiplier)
        self.hw = int(conv_hw)
        self.fc = Linear(latent_dim, self.c * self.hw * self.hw, device=device)
        self.deconvs = nn.ModuleList(
            [ConvTranspose2d(self.c, self.c, 3, stride=1, device=device) for _ in range(3)]
            + [ConvTranspose2d(self.c, int(output_channels), 3, stride=2, device=device)]
        )

    def forward(self, latent: torch.Tensor) -> torch.Tensor:
        lead = latent.shape[:-1]
        x = self.fc(latent).reshape(-1, self.hw, self.hw, self.c).permute(0, 3, 1, 2)
        for deconv in self.deconvs[:-1]:
            x = torch.relu(deconv(x))
        x = F.pad(self.deconvs[-1](x), (0, 1, 0, 1))  # one zero row and column, bottom and right
        return x.reshape(lead + x.shape[1:])


class SACAEMLPDecoder(nn.Module):
    def __init__(self, latent_dim: int, keys: Sequence[str], output_dims: Sequence[int], dense_units: int,
                 mlp_layers: int, activation, device=None):
        super().__init__()
        self.mlp = MLP(latent_dim, [dense_units] * mlp_layers, activation, device=device)
        self.heads = nn.ModuleDict({k: Linear(dense_units, int(d), device=device) for k, d in zip(keys, output_dims)})

    def forward(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.mlp(latent)
        return {k: head(x) for k, head in self.heads.items()}


class SACAEDecoder(nn.Module):
    """Per-key reconstructions ``{key: [..., C, H, W] or [..., dim]}`` of the latent."""

    def __init__(self, latent_dim: int, cnn_keys: Sequence[str], mlp_keys: Sequence[str], cnn_channels: Sequence[int],
                 mlp_dims: Sequence[int], conv_hw: int, channels_multiplier: int, dense_units: int, mlp_layers: int,
                 dense_act="relu", device=None):
        super().__init__()
        self.cnn_keys, self.cnn_channels = list(cnn_keys), [int(c) for c in cnn_channels]
        self.cnn_decoder = (SACAECNNDecoder(latent_dim, sum(self.cnn_channels), conv_hw, channels_multiplier, device)
                            if self.cnn_keys else None)
        self.mlp_decoder = (SACAEMLPDecoder(latent_dim, mlp_keys, mlp_dims, dense_units, mlp_layers, dense_act, device)
                            if mlp_keys else None)

    def forward(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        if self.cnn_decoder is not None:
            parts = torch.split(self.cnn_decoder(latent), self.cnn_channels, dim=-3)
            out.update(zip(self.cnn_keys, parts))
        if self.mlp_decoder is not None:
            out.update(self.mlp_decoder(latent))
        return out


class SACAEActor(nn.Module):
    """The actor trunk over the encoder's features → ``(mean, std)``."""

    def __init__(self, features_dim: int, action_dim: int, hidden_size: int = 1024, device=None):
        super().__init__()
        self.mlp = MLP(features_dim, (hidden_size, hidden_size), "relu", device=device)
        self.fc_mean = Linear(hidden_size, action_dim, device=device)
        self.fc_logstd = Linear(hidden_size, action_dim, device=device)

    def forward(self, features: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.mlp(features)
        log_std = torch.tanh(self.fc_logstd(x))
        log_std = LOG_STD_MIN + 0.5 * (LOG_STD_MAX - LOG_STD_MIN) * (log_std + 1.0)
        return self.fc_mean(x), torch.exp(log_std)


@torch.no_grad()
def sac_ae_weight_init(module: nn.Module, generator: Optional[torch.Generator]) -> nn.Module:
    """Orthogonal Linear weights, delta-orthogonal (transposed) convolutions,
    zero biases; LayerNorms and stacked weights left as they are."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            nn.init.orthogonal_(m.weight, generator=generator)
        elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            kh, kw = m.weight.shape[-2:]
            m.weight.zero_()
            tap = torch.empty(m.weight.shape[:2])
            nn.init.orthogonal_(tap, generator=generator)
            m.weight[:, :, kh // 2, kw // 2] = tap.to(m.weight.device)
        else:
            continue
        if m.bias is not None:
            m.bias.zero_()
    return module


def build_agent(cfg, act_dim: int, observation_space, generator: Optional[torch.Generator], device=None,
                training: bool = True) -> Dict[str, nn.Module]:
    """The agent at ``cfg``'s widths, initialized from ``generator`` on the
    CPU and moved to ``device``: ``encoder``, ``actor`` and, for training,
    ``target_encoder`` (a copy), ``qfs``, ``target_qfs`` (a copy), ``decoder``
    and ``log_alpha`` (a 0-dim parameter)."""
    cnn_keys, mlp_keys = list(cfg.cnn_keys.encoder), list(cfg.mlp_keys.encoder)
    screen = int(cfg.env.screen_size)
    enc_cfg, dec_cfg = cfg.algo.encoder, cfg.algo.decoder

    def make_encoder():
        return SACAEEncoder(
            cnn_keys, mlp_keys, sum(int(np.prod(observation_space[k].shape[:-2])) for k in cnn_keys),
            sum(int(np.prod(observation_space[k].shape)) for k in mlp_keys), int(enc_cfg.features_dim),
            int(enc_cfg.cnn_channels_multiplier), screen, int(enc_cfg.dense_units), int(enc_cfg.mlp_layers),
            enc_cfg.dense_act, bool(enc_cfg.layer_norm),
        )

    encoder = sac_ae_weight_init(make_encoder(), generator)
    feat = encoder.output_dim
    actor = sac_ae_weight_init(SACAEActor(feat, act_dim, int(cfg.algo.actor.hidden_size)), generator)
    agent = {"encoder": encoder, "actor": actor}
    if training:
        hidden = int(cfg.algo.critic.hidden_size)
        qfs = lecun_normal_(CriticEnsemble(int(cfg.algo.critic.n), feat + act_dim, (hidden, hidden)), generator)
        decoder = sac_ae_weight_init(
            SACAEDecoder(
                feat, list(cfg.cnn_keys.decoder), list(cfg.mlp_keys.decoder),
                [int(np.prod(observation_space[k].shape[:-2])) for k in cfg.cnn_keys.decoder],
                [int(np.prod(observation_space[k].shape)) for k in cfg.mlp_keys.decoder], conv_output_hw(screen),
                int(dec_cfg.cnn_channels_multiplier), int(dec_cfg.dense_units), int(dec_cfg.mlp_layers),
                dec_cfg.dense_act,
            ),
            generator,
        )
        target_encoder = make_encoder()
        target_encoder.load_state_dict(encoder.state_dict())
        target_qfs = CriticEnsemble(int(cfg.algo.critic.n), feat + act_dim, (hidden, hidden))
        target_qfs.load_state_dict(qfs.state_dict())
        for target in (target_encoder, target_qfs):
            target.requires_grad_(False)
        agent.update(target_encoder=target_encoder, qfs=qfs, target_qfs=target_qfs, decoder=decoder,
                     log_alpha=nn.Parameter(torch.log(torch.tensor(float(cfg.algo.alpha.alpha)))))
    return {k: (v.to(device) if isinstance(v, nn.Module) else nn.Parameter(v.detach().to(device)))
            for k, v in agent.items()}


def preprocess_obs(obs: torch.Tensor, bits: int = 8, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ``bits``-bit pixel target (https://arxiv.org/abs/1807.03039):
    floor to ``bits`` bits, scale to [0, 1), add the uniform dequantization
    ``noise`` / bins when given, shift to [-0.5, 0.5)."""
    bins = 2**bits
    obs = obs.float()
    if bits < 8:
        obs = torch.floor(obs / 2 ** (8 - bits))
    obs = obs / bins
    if noise is not None:
        obs = obs + noise / bins
    return obs - 0.5

"""SAC-AE training (counterpart of ``sheeprl_tpu/algos/sac_ae/sac_ae.py``):
pixel SAC with a convolutional autoencoder.

One gradient step, in the JAX step's order:

1. the soft critic, which trains the encoder too: the TD target of the
   target Q-functions over the target encoder's features of the next
   observation, at the actor's sample from the encoder's; the Q-functions'
   and the encoder's Adam step (one optimizer, ``qf``);
2. the target EMAs, the Q-functions' at ``algo.tau`` and the encoder's at
   ``algo.encoder.tau``, gated by the update's ``do_ema``;
3. the actor and ``log_alpha`` on the fresh encoder's features, detached,
   gated by ``do_actor`` (their parameters and Adam state keep their values
   when it is off);
4. the autoencoder: the decoder's reconstruction of the fresh encoder's
   latent against the 5-bit ``preprocess_obs`` target, plus ``l2_lambda``
   on the latent; the encoder's (``encoder``) and the decoder's
   (``decoder``, with its decoupled ``weight_decay``) Adam steps, gated by
   ``do_decoder``.

The gates are device values of the step's ``gates`` vector, filled before
each replay, so one captured graph serves every cadence; as in JAX, the
gated-off parts are computed and their updates dropped. The step's noise
(the two samples' normals and the reconstruction targets' uniforms) is
drawn outside it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import (
    _no_param_grads,
    adam_for,
    give_zero_grads,
    read_resume_checkpoint,
)
from sheeprl_tpu_torch.algos.sac import sac
from sheeprl_tpu_torch.algos.sac.agent import greedy_action, squash_sample
from sheeprl_tpu_torch.algos.sac.loss import critic_loss, policy_loss
from sheeprl_tpu_torch.algos.sac.sac import StepProgram, actor_and_alpha_update, ema_update
from sheeprl_tpu_torch.algos.sac_ae.agent import build_agent, preprocess_obs
from sheeprl_tpu_torch.algos.sac_ae.utils import normalize_obs, normalize_obs_tensors, prepare_obs
from sheeprl_tpu_torch.obs.learn import learn_tap, probe_losses, probe_optimizer, probe_update
from sheeprl_tpu_torch.utils.optim import Adam
from sheeprl_tpu_torch.utils.registry import register_algorithm

__all__ = ["LOSS_NAMES", "build_optimizers_and_state", "build_train_fn", "cadence_gates", "main"]

LOSS_NAMES = sac.LOSS_NAMES + ("Loss/reconstruction_loss",)
_MODULES = ("encoder", "target_encoder", "qfs", "target_qfs", "actor", "decoder")
_TRAINED = ("encoder", "qfs", "actor", "decoder")


def build_optimizers_and_state(cfg, agent: Dict[str, Any], generator=None) -> Dict[str, Any]:
    """The agent and its five ``utils.optim.Adam`` (the JAX ``opt_states``
    keys): ``qf`` over the encoder and the Q-functions, ``actor``, ``alpha``,
    ``encoder`` and ``decoder``."""
    o = cfg.algo.critic.optimizer
    qf = Adam(list(agent["encoder"].parameters()) + list(agent["qfs"].parameters()), lr=float(o.lr),
              betas=tuple(o.betas), eps=float(o.eps), weight_decay=float(o.weight_decay))
    a = cfg.algo.alpha.optimizer
    opt = {
        "qf": qf,
        "actor": adam_for(agent["actor"], cfg.algo.actor.optimizer),
        "alpha": Adam([agent["log_alpha"]], lr=float(a.lr), betas=tuple(a.betas), eps=float(a.eps),
                      weight_decay=float(a.weight_decay)),
        "encoder": adam_for(agent["encoder"], cfg.algo.encoder.optimizer),
        "decoder": adam_for(agent["decoder"], cfg.algo.decoder.optimizer),
    }
    return {**agent, "opt": opt, "generator": generator}


def _prepare(state: Dict[str, Any]) -> None:
    give_zero_grads([state[k] for k in _TRAINED])
    if state["log_alpha"].grad is None:
        state["log_alpha"].grad = torch.zeros_like(state["log_alpha"])


def cadence_gates(cfg, do_ema: bool, do_actor: bool, do_decoder: bool) -> np.ndarray:
    """The step's ``gates``: the two EMAs' ``(τ, 1−τ)`` (``(0, 1)`` off),
    then ``do_actor`` and ``do_decoder`` as 1 or 0."""
    tau, enc_tau = float(cfg.algo.tau), float(cfg.algo.encoder.tau)
    ema = [tau, 1.0 - tau, enc_tau, 1.0 - enc_tau] if do_ema else [0.0, 1.0, 0.0, 1.0]
    return np.asarray(ema + [float(do_actor), float(do_decoder)], np.float32)


def build_train_fn(cfg, act_dim: int, target_entropy: float) -> StepProgram:
    """The gradient step as a :class:`~sheeprl_tpu_torch.algos.sac.sac.StepProgram`.
    ``data`` holds ``[B, ...]`` device tensors: each observation key and its
    ``next_<key>`` (uint8 pixels ``[B, C, H, W]``), ``actions``, ``rewards``,
    ``dones``; ``noise`` holds ``next`` and ``actor`` (``[B, A]`` normals)
    and ``recon_<key>`` (the uniforms of each CNN decoder key's target);
    ``gates`` is :func:`cadence_gates`'. Returns ``LOSS_NAMES``' values."""
    gamma, n_critics = float(cfg.algo.gamma), int(cfg.algo.critic.n)
    l2_lambda = float(cfg.algo.decoder.l2_lambda)
    cnn_keys, mlp_keys = list(cfg.cnn_keys.encoder), list(cfg.mlp_keys.encoder)
    cnn_dec_keys, mlp_dec_keys = list(cfg.cnn_keys.decoder), list(cfg.mlp_keys.decoder)

    def normalize(data, prefix=""):
        return normalize_obs_tensors({k: data[prefix + k] for k in cnn_keys + mlp_keys}, cnn_keys)

    def body(state, data, noise, gates):
        encoder, target_encoder, qfs, target_qfs, actor, decoder = (state[k] for k in _MODULES)
        log_alpha, opt = state["log_alpha"], state["opt"]
        scale, bias = state["action_scale"], state["action_bias"]
        sac._zero_grads([p for k in _TRAINED for p in state[k].parameters()] + [log_alpha])
        obs, next_obs = normalize(data), normalize(data, "next_")
        alpha = torch.exp(log_alpha.detach())
        with torch.no_grad():
            next_feat = target_encoder(next_obs)
            mean, std = actor(encoder(next_obs))
            next_actions, next_logprob = squash_sample(mean, std, noise["next"], scale, bias)
            min_target = torch.amin(target_qfs(next_feat, next_actions), dim=-1, keepdim=True)
            td_target = data["rewards"] + (1.0 - data["dones"]) * gamma * (min_target - alpha * next_logprob)

        qf_loss = critic_loss(qfs(encoder(obs), data["actions"]), td_target, n_critics)
        qf_loss.backward()
        probed = probe_optimizer("critic", opt["qf"])
        opt["qf"].step()
        probed()
        ema_update(target_qfs, qfs, gates[0], gates[1])
        ema_update(target_encoder, encoder, gates[2], gates[3])

        with torch.no_grad():
            feat = encoder(obs, detach_conv=True)

        def actor_loss_fn():
            mean, std = actor(feat)
            actions, logprob = squash_sample(mean, std, noise["actor"], scale, bias)
            with _no_param_grads(qfs):
                min_q = torch.amin(qfs(feat, actions), dim=-1, keepdim=True)
            return policy_loss(alpha, logprob, min_q), logprob

        actor_loss, alpha_loss = actor_and_alpha_update(state, actor_loss_fn, alpha, target_entropy,
                                                        gate=gates[4] > 0)

        sac._zero_grads(list(encoder.parameters()))
        hidden = encoder(obs)
        recon = decoder(hidden)
        latent_l2 = l2_lambda * torch.mean(0.5 * torch.sum(hidden**2, -1))
        recon_loss = 0.0
        for k in cnn_dec_keys:
            target = preprocess_obs(data[k], bits=5, noise=noise[f"recon_{k}"])
            recon_loss = recon_loss + (torch.mean((target - recon[k]) ** 2) + latent_l2)
        for k in mlp_dec_keys:
            recon_loss = recon_loss + (torch.mean((data[k] - recon[k]) ** 2) + latent_l2)
        recon_loss.backward()
        do_decoder = gates[5] > 0
        # the JAX step probes the decoder's module over the encoder's and the decoder's gradients
        decoder_params = list(decoder.parameters())
        probed = probe_update("decoder", [p.grad for p in list(encoder.parameters()) + decoder_params],
                              decoder_params, opt["decoder"])
        opt["encoder"].step(gate=do_decoder)
        opt["decoder"].step(gate=do_decoder)
        probed()
        probe_losses(qf_loss, actor_loss, alpha_loss, recon_loss)
        return torch.stack([qf_loss.detach(), actor_loss, alpha_loss, recon_loss.detach()])

    def draw_noise(state, data, generator, device):
        batch = data["rewards"].shape[0]
        noise = {k: torch.randn((batch, act_dim), generator=generator, device=device) for k in ("next", "actor")}
        for k in cnn_dec_keys:
            noise[f"recon_{k}"] = torch.rand(data[k].shape, generator=generator, device=device)
        return noise

    return StepProgram(body, draw_noise, _prepare, n_gates=6, learn_tap=learn_tap())


def sac_ae_train_round(cfg, program: StepProgram, state: Dict[str, Any], n_envs: int):
    """SAC-AE's updates ``first..last``: from ``learning_starts`` on, G
    gradient steps an update (``learning_starts`` times G at
    ``learning_starts``: the catch-up burst), every step of an update under
    its ``do_ema``, ``do_actor`` and ``do_decoder``."""
    per_rank_gradient_steps = int(cfg.algo.per_rank_gradient_steps)
    ema_every = int(cfg.algo.critic.target_network_frequency) // n_envs + 1
    actor_every = int(cfg.algo.actor.network_frequency) // n_envs + 1
    decoder_every = int(cfg.algo.decoder.update_freq) // n_envs + 1

    def train_round(staging, first: int, last: int, learning_starts: int, counters) -> Optional[torch.Tensor]:
        metrics = None
        for u in range(first, last + 1):
            if u < learning_starts:
                continue
            g_total = (learning_starts if u == learning_starts else 1) * per_rank_gradient_steps
            if g_total <= 0:
                continue
            batch = staging.sample_device(cfg.per_rank_batch_size, n_samples=g_total,
                                          sample_next_obs=cfg.buffer.sample_next_obs)
            do = (u % ema_every == 0, u % actor_every == 0, u % decoder_every == 0)
            metrics = program.burst(state, batch, cadence_gates(cfg, *do))
            counters["gradient_steps"] += g_total
            for name, on in zip(("ema_steps", "actor_steps", "decoder_steps"), do):
                counters[name] = counters.get(name, 0) + (g_total if on else 0)
            counters["train_bursts"] += 1
        return metrics

    return train_round


def sac_ae_acting_policy(state: Dict[str, Any], cnn_keys):
    def policy(obs, eps):
        mean, std = state["actor"](state["encoder"](normalize_obs_tensors(obs, cnn_keys)))
        return squash_sample(mean, std, eps, state["action_scale"], state["action_bias"])[0]

    return policy


def sac_ae_greedy(state: Dict[str, Any], cfg):
    cnn_keys, mlp_keys = list(cfg.cnn_keys.encoder), list(cfg.mlp_keys.encoder)

    @torch.no_grad()
    def act(obs):
        x = normalize_obs(prepare_obs(obs, cnn_keys, mlp_keys, 1), cnn_keys, state["action_scale"].device)
        mean, _ = state["actor"](state["encoder"](x))
        return greedy_action(mean, state["action_scale"], state["action_bias"]).cpu().numpy()

    return act


@register_algorithm()
def main(fabric, cfg) -> Dict[str, Any]:
    """The SAC-AE training run (SAC's loop on the Python plane, the pixel
    keys stored as uint8 with the frame stack folded into the channels)."""
    # These arguments cannot be changed
    cfg.env.screen_size = 64
    run = sac.open_run(fabric, cfg, "SAC-AE")
    cnn_keys, mlp_keys = list(cfg.cnn_keys.encoder), list(cfg.mlp_keys.encoder)
    if (
        len(set(cnn_keys).intersection(set(cfg.cnn_keys.decoder))) == 0
        and len(set(mlp_keys).intersection(set(cfg.mlp_keys.decoder))) == 0
    ):
        raise RuntimeError("The CNN keys or the MLP keys of the encoder and decoder must not be disjoint")
    if len(set(cfg.cnn_keys.decoder) - set(cnn_keys)) > 0:
        raise RuntimeError("The CNN keys of the decoder must be contained in the encoder ones")
    if len(set(cfg.mlp_keys.decoder) - set(mlp_keys)) > 0:
        raise RuntimeError("The MLP keys of the decoder must be contained in the encoder ones")
    if cfg.metric.log_level > 0:
        fabric.print("Encoder CNN keys:", cnn_keys)
        fabric.print("Encoder MLP keys:", mlp_keys)
        fabric.print("Decoder CNN keys:", cfg.cnn_keys.decoder)
        fabric.print("Decoder MLP keys:", cfg.mlp_keys.decoder)
    act_dim = run.act_dim
    agent = build_agent(cfg, act_dim, run.observation_space, torch.Generator().manual_seed(int(cfg.seed)),
                        device=run.device)
    state = build_optimizers_and_state(cfg, agent, generator=run.generator)
    state["action_scale"] = torch.as_tensor(run.action_scale).to(run.device)
    state["action_bias"] = torch.as_tensor(run.action_bias).to(run.device)
    resumed = read_resume_checkpoint(fabric, cfg)
    if resumed is not None:
        sac.load_agent_state(state, resumed["agent"], resumed["opt_states"], _MODULES)
    program = build_train_fn(cfg, act_dim, -float(act_dim))

    def checkpoint_state():
        agent_tree, opt_states = sac.agent_state_dict(state, _MODULES)
        return {"agent": agent_tree, "opt_states": opt_states}

    return sac.train_loop(
        fabric, cfg, run, state, resumed,
        obs_rows=lambda o, n: prepare_obs(o, cnn_keys, mlp_keys, n),
        stored_keys=tuple(cnn_keys + mlp_keys),
        acting_policy=sac_ae_acting_policy(state, cnn_keys),
        train_round=sac_ae_train_round(cfg, program, state, run.n_envs),
        loss_names=LOSS_NAMES,
        checkpoint_state=checkpoint_state,
        publish=lambda: {"agent": {k: state[k].state_dict() for k in ("encoder", "actor")}},
        greedy=sac_ae_greedy(state, cfg),
        programs=[program],
    )

"""DreamerV1 training (counterpart of ``sheeprl_tpu/algos/dreamer_v1/dreamer_v1.py``):
the gradient step (``build_train_fn``, ``build_optimizers_and_state``) and
the training run (:func:`main`, registered as ``dreamer_v1``).

The step keeps the JAX step's order:

1. the world model: the posterior loop over T from zero states with the
   actions as stored (row t holds the action that led to observation t) and
   no ``is_first`` reset, the prior's statistics batched over ``[T, B]``,
   the decoders and heads, DreamerV1's loss; its update;
2. the actor, on the **updated** world model, trained by dynamics
   backpropagation: a ``horizon``-step imagination from the detached
   posteriors (the start is not part of the trajectory), each action
   sampled with its reparameterized (or straight-through) gradient from the
   detached latent, the critic's values, the V1 λ-targets and
   ``-mean(discount · λ)``; the gradient runs back through the imagined
   dynamics into the actor alone (``_no_param_grads`` holds the world model
   and the critic); its update;
3. the critic, a unit Gaussian on the detached trajectories but the last,
   against the λ-targets, weighted by the discount; its update.

There is no target critic. Each update clips its gradients to their global
norm (``clip_gradients``, 100 in the presets) as optax does. Like
DreamerV2's, the step is PyTorch on one device, updating the state in place,
wrapped as a :class:`~sheeprl_tpu_torch.train.burst.TrainProgram` and
replayed from one CUDA graph a step in a burst on the card; its noise (the
posterior's and the imagined priors' standard normals, the actions'
sampling noise) is drawn outside the step.

The run (:func:`main`) is DreamerV2's loop (``dreamer_v2.train_loop``) with
the sequential buffer, no pretraining burst and no target updates, acting
with DreamerV1's player (its exploration noise at ``expl_amount``, decayed
when ``algo.actor.expl_decay``); its checkpoint holds the modules, the
optimizers' state and ``expl_decay_steps``.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_v1.agent import (
    actor_noise,
    build_actor_dists,
    build_agent,
    build_player_fns,
    resolve_actor_distribution,
    sample_actor_actions,
)
from sheeprl_tpu_torch.algos.dreamer_v1.loss import gaussian_independent, reconstruction_loss
from sheeprl_tpu_torch.algos.dreamer_v1.utils import compute_lambda_values, normalize_obs_tensors
from sheeprl_tpu_torch.algos.dreamer_v2 import dreamer_v2 as dv2
from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import _no_param_grads, _step, adam_for, give_zero_grads
from sheeprl_tpu_torch.distributions import Bernoulli, Independent
from sheeprl_tpu_torch.train.burst import TrainProgram, build_train_burst
from sheeprl_tpu_torch.utils.registry import register_algorithm

__all__ = [
    "agent_state_dict",
    "build_losses",
    "build_optimizers_and_state",
    "build_train_fn",
    "draw_noise",
    "load_agent_state",
    "main",
]

_MODULES = ("world_model", "actor", "critic")


def build_optimizers_and_state(cfg, world_model, actor, critic, generator=None) -> Dict[str, Any]:
    """The agent state a train step updates: the three modules, one
    ``utils.optim.Adam`` each, and the generator noise is drawn from when
    the step is given none."""
    modules = {"world_model": world_model, "actor": actor, "critic": critic}
    opt = {name: adam_for(module, cfg.algo[name].optimizer) for name, module in modules.items()}
    return {**modules, "opt": opt, "generator": generator}


def draw_noise(cfg, actions_dim: Sequence[int], T: int, B: int, generator: Optional[torch.Generator], device,
               is_continuous: bool = False, prefix: str = "") -> Dict[str, Any]:
    """The noise of one step: the posterior's standard normals ``[T, B,
    S]``, the imagined priors' ``[horizon, T·B, S]`` and each action head's
    sampling noise ``[horizon, T·B, dim]`` (``actor_noise``: Gumbels for a
    categorical head, the continuous head's base noise for its one head of
    width ``Σdims``). With ``prefix`` only the imagination's, under
    ``{prefix}prior`` and ``{prefix}actions`` (P2E's exploration actor)."""
    wm_cfg = cfg.algo.world_model
    S, horizon = int(wm_cfg.stochastic_size), int(cfg.algo.horizon)
    distribution = resolve_actor_distribution(cfg.distribution.get("type", "auto"), is_continuous)
    heads = [int(np.sum(actions_dim))] if is_continuous else [int(d) for d in actions_dim]
    noise = {} if prefix else {"posterior": torch.randn((T, B, S), generator=generator, device=device)}
    noise[f"{prefix}prior"] = torch.randn((horizon, T * B, S), generator=generator, device=device)
    noise[f"{prefix}actions"] = [actor_noise(distribution, (horizon, T * B, d), generator, device) for d in heads]
    return noise


def _prepare(state: Dict[str, Any]) -> None:
    give_zero_grads(state[name] for name in _MODULES)


def build_losses(cfg, actions_dim: Sequence[int], is_continuous: bool) -> SimpleNamespace:
    """The step's losses at ``cfg``'s settings: ``world_model_loss(wm, data,
    posterior_noise) -> (loss, metrics, posteriors, recurrents,
    embedded)`` (the last three detached), ``imagination(wm, actor,
    posteriors, recurrents, prior_noise, action_noise) -> (trajectories [H,
    TB, L], actions [H, TB, A])``, ``behaviour_loss(wm, actor, critic,
    posteriors, recurrents, prior_noise, action_noise, reward_fn) -> (loss,
    aux)`` (``reward_fn(trajectories, actions)`` the reward: the reward
    head's for DreamerV1's actor) and ``critic_loss(critic, trajectories,
    lambda_values, discount)``, with the clip norms (``clips``)."""
    cnn_keys, mlp_keys = list(cfg.cnn_keys.encoder), list(cfg.mlp_keys.encoder)
    wm_cfg = cfg.algo.world_model
    S, rec_size = int(wm_cfg.stochastic_size), int(wm_cfg.recurrent_model.recurrent_state_size)
    horizon, gamma, lmbda = int(cfg.algo.horizon), float(cfg.algo.gamma), float(cfg.algo.lmbda)
    use_continues = bool(wm_cfg.use_continues)
    distribution = resolve_actor_distribution(cfg.distribution.get("type", "auto"), is_continuous)
    init_std, min_std = float(cfg.algo.actor.init_std), float(cfg.algo.actor.min_std)
    clips = {name: float(cfg.algo[name].clip_gradients) for name in _MODULES}

    def world_model_loss(wm, data, noise):
        T, B = data["rewards"].shape[:2]
        batch_obs = normalize_obs_tensors({k: data[k] for k in cnn_keys + mlp_keys}, cnn_keys)
        embedded = wm.encode(batch_obs)
        posterior = embedded.new_zeros((B, S))
        recurrent = embedded.new_zeros((B, rec_size))
        recurrents, posteriors, means, stds = [], [], [], []
        for t in range(T):
            recurrent, posterior, (mean, std) = wm.rssm.dynamic_posterior(
                posterior, recurrent, data["actions"][t], embedded[t], noise=noise[t]
            )
            recurrents.append(recurrent)
            posteriors.append(posterior)
            means.append(mean)
            stds.append(std)
        recurrents, posteriors = torch.stack(recurrents), torch.stack(posteriors)
        prior_mean, prior_std = wm.rssm.prior_stats(recurrents)
        latents = torch.cat([posteriors, recurrents], dim=-1)
        recon = wm.decode(latents)
        qo = {k: gaussian_independent(recon[k], 1.0, 3 if k in cnn_keys else 1) for k in recon}
        qr = gaussian_independent(wm.reward(latents), 1.0, 1)
        qc = continue_targets = None
        if use_continues:
            qc = Independent(Bernoulli(logits=wm.continues(latents)), 1)
            continue_targets = 1.0 - data["dones"]
        loss, metrics = reconstruction_loss(
            qo, batch_obs, qr, data["rewards"],
            gaussian_independent(torch.stack(means), torch.stack(stds), 1),
            gaussian_independent(prior_mean, prior_std, 1),
            float(wm_cfg.kl_free_nats), float(wm_cfg.kl_regularizer), qc, continue_targets,
            float(wm_cfg.continue_scale_factor),
        )
        return loss, metrics, posteriors.detach(), recurrents.detach(), embedded.detach()

    def imagination(wm, actor, posteriors, recurrents, prior_noise, action_noise):
        prior = posteriors.reshape(-1, S)
        recurrent = recurrents.reshape(-1, rec_size)
        latent = torch.cat([prior, recurrent], dim=-1)
        latents, actions = [], []
        for i in range(horizon):
            dists = build_actor_dists(actor(latent.detach()), is_continuous, distribution, init_std, min_std, 0.0)
            action = torch.cat(
                sample_actor_actions(dists, is_continuous, is_training=True, noise=[n[i] for n in action_noise]),
                dim=-1,
            )
            prior, recurrent = wm.rssm.imagination(prior, recurrent, action, noise=prior_noise[i])
            latent = torch.cat([prior, recurrent], dim=-1)
            latents.append(latent)
            actions.append(action)
        return torch.stack(latents), torch.stack(actions)

    def behaviour_loss(wm, actor, critic, posteriors, recurrents, prior_noise, action_noise, reward_fn):
        traj, imagined_actions = imagination(wm, actor, posteriors, recurrents, prior_noise, action_noise)
        predicted_values = critic(traj)
        reward = reward_fn(traj, imagined_actions)
        if use_continues:
            continues = torch.sigmoid(wm.continues(traj)) * gamma
        else:
            continues = torch.ones_like(reward.detach()) * gamma
        lambda_values = compute_lambda_values(reward, predicted_values, continues, predicted_values[-1], lmbda)
        # weighted down by how likely the imagined trajectory would have ended
        discount = torch.cumprod(torch.cat([torch.ones_like(continues[:1]), continues[:-2]]), dim=0).detach()
        policy_loss = -torch.mean(discount * lambda_values)
        aux = {"trajectories": traj.detach(), "lambda_values": lambda_values.detach(), "discount": discount,
               "reward_mean": reward.detach().mean(), "values_mean": predicted_values.detach().mean()}
        return policy_loss, aux

    def critic_loss(critic, traj, lambda_values, discount):
        qv = gaussian_independent(critic(traj[:-1]), 1.0, 1)
        return -torch.mean(discount[..., 0] * qv.log_prob(lambda_values))

    return SimpleNamespace(
        world_model_loss=world_model_loss, imagination=imagination, behaviour_loss=behaviour_loss,
        critic_loss=critic_loss, clips=clips,
    )


def behaviour_update(losses, wm, actor, critic, opt_actor, opt_critic, clips, posteriors, recurrents, prior_noise,
                     action_noise, reward_fn):
    """One actor's update, then its critic's: the behaviour loss
    differentiated in the actor alone (the world model and the critic held),
    its step, then the critic's loss on the detached trajectories and its
    step. Returns ``(policy_loss, value_loss, aux, actor_grad_norm,
    critic_grad_norm)``."""
    with _no_param_grads(wm, critic):
        policy_loss, aux = losses.behaviour_loss(wm, actor, critic, posteriors, recurrents, prior_noise,
                                                 action_noise, reward_fn)
        policy_loss.backward()
    actor_norm = _step(actor, opt_actor, clips["actor"])
    value_loss = losses.critic_loss(critic, aux["trajectories"], aux["lambda_values"], aux["discount"])
    value_loss.backward()
    critic_norm = _step(critic, opt_critic, clips["critic"])
    return policy_loss.detach(), value_loss.detach(), aux, actor_norm, critic_norm


def build_train_fn(cfg, actions_dim: Sequence[int], is_continuous: bool) -> TrainProgram:
    """The gradient step as a :class:`~sheeprl_tpu_torch.train.burst.TrainProgram`:
    ``program(state, data, noise=None) -> metrics`` is one eager step,
    ``program.burst(state, data_stack, taus)`` the staged burst (``taus``
    only count the steps: DreamerV1 has no target), each step replayed from
    one CUDA graph on the card.

    ``state`` comes from :func:`build_optimizers_and_state`; ``data`` holds
    ``[T, B, ...]`` tensors on the modules' device: the observation keys
    (uint8 pixels ``[T, B, C, H, W]``), ``actions`` (one-hot or continuous),
    ``rewards`` and ``dones`` (``[T, B, 1]``); any other key is not read.
    ``noise`` is :func:`draw_noise`'s dict. The metrics are 0-dim device
    tensors under the JAX step's names."""
    losses = build_losses(cfg, actions_dim, is_continuous)
    clips = losses.clips

    def body(state: Dict[str, Any], data: Dict[str, torch.Tensor], noise, tau: torch.Tensor):
        del tau  # no target critic
        wm, actor, critic, opt = state["world_model"], state["actor"], state["critic"], state["opt"]
        with torch.no_grad():
            torch._foreach_zero_([p.grad for name in _MODULES for p in state[name].parameters()])

        wm_loss, metrics, posteriors, recurrents, _ = losses.world_model_loss(wm, data, noise["posterior"])
        wm_loss.backward()
        wm_norm = _step(wm, opt["world_model"], clips["world_model"])

        policy_loss, value_loss, aux, actor_norm, critic_norm = behaviour_update(
            losses, wm, actor, critic, opt["actor"], opt["critic"], clips, posteriors, recurrents, noise["prior"],
            noise["actions"], lambda traj, actions: wm.reward(traj),
        )
        metrics = dict(metrics)
        metrics["Loss/policy_loss"] = policy_loss
        metrics["User/PredictedRewards"] = aux["reward_mean"]
        metrics["User/LambdaValues"] = aux["lambda_values"].mean()
        metrics["Loss/value_loss"] = value_loss
        metrics.update({"Grads/world_model": wm_norm, "Grads/actor": actor_norm, "Grads/critic": critic_norm})
        return metrics

    def noise_for(T: int, B: int, generator: Optional[torch.Generator], device):
        return draw_noise(cfg, actions_dim, T, B, generator, device, is_continuous)

    return build_train_burst(body, noise_for, _prepare)


# ---------------------------------------------------------------------------
# the training run
# ---------------------------------------------------------------------------


def agent_state_dict(state: Dict[str, Any], modules: Sequence[str] = _MODULES) -> Dict[str, Any]:
    """The checkpoint's ``agent`` tree: each module's ``state_dict`` and each
    optimizer's per-parameter state."""
    out: Dict[str, Any] = {name: state[name].state_dict() for name in modules}
    out["opt"] = {name: {"state": opt.state_dict()["state"]} for name, opt in state["opt"].items()}
    return out


def load_agent_state(state: Dict[str, Any], agent: Dict[str, Any], modules: Sequence[str] = _MODULES) -> None:
    """Load an :func:`agent_state_dict` tree (numpy leaves) into ``state`` in place."""
    for name in modules:
        state[name].load_state_dict({k: torch.as_tensor(v) for k, v in agent[name].items()})
    for name, opt in state["opt"].items():
        dv2.load_optimizer_state(opt, agent["opt"][name])


@register_algorithm()
def main(fabric, cfg) -> Dict[str, Any]:
    """The DreamerV1 training run (``dreamer_v2.train_loop``, sequential
    buffer). Returns the loop's result."""
    dv2._unsupported(cfg)
    # These arguments cannot be changed
    cfg.env.screen_size = 64
    cfg.env.frame_stack = 1
    run = dv2.open_run(fabric, cfg)
    modules = build_agent(
        cfg, run.actions_dim, run.is_continuous, run.observation_space.spaces, seed=cfg.seed, device=run.device,
        training=True,
    )
    state = build_optimizers_and_state(cfg, *modules, generator=run.generator)
    resumed = dv2.read_resume_checkpoint(fabric, cfg)
    if resumed is not None:
        load_agent_state(state, resumed["agent"])
    player_fns = build_player_fns(state["world_model"], state["actor"], cfg, run.actions_dim, run.is_continuous)
    return dv2.train_loop(
        fabric, cfg, run, state, build_train_fn(cfg, run.actions_dim, run.is_continuous), resumed,
        players=[player_fns],
        checkpoint_state=lambda: {"agent": agent_state_dict(state)},
        publish=lambda: {"agent": {k: state[k].state_dict() for k in ("world_model", "actor")}},
        test_player=player_fns,
        buffer_kind="sequential",
        hard_target_updates=False,
        replay_state=resumed.get("rb") if resumed is not None and cfg.buffer.get("checkpoint", False) else None,
    )

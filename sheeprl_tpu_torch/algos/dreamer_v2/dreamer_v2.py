"""One DreamerV2 gradient step (counterpart of ``build_train_fn`` and
``build_optimizers_and_state`` in ``sheeprl_tpu/algos/dreamer_v2/dreamer_v2.py``).

The step keeps the reference's order:

1. the target critic is chosen by ``tau`` before any update (``tau=1``: a
   hard copy of the critic; ``tau=0``: unchanged);
2. the world model: the posterior loop over T with ``is_first[0] = 1`` and
   the actions unshifted (row t holds the action that led to observation t),
   the prior logits batched over ``[T, B]``, the decoders and heads, the
   KL-balanced loss; its update;
3. the actor, on the **updated** world model: a ``horizon``-step imagination
   from the detached posteriors with the action computed inside the loop
   from the detached latent, the target critic's values, λ-returns, and the
   reinforce/dynamics mix over ``traj[:-2]``; its update;
4. the critic on the actor step's detached trajectories and λ-returns; its
   update.

The world model and the target critic take no gradient during the actor
loss (the JAX step differentiates the actor loss in the actor's parameters
only), but autograd still runs back through the imagination's recurrent
cells: with ``objective_mix = 1`` the dynamics term is multiplied by 0, as
in the reference, and its backward is kept.

The JAX package runs the step as one SPMD program; here it is eager PyTorch
on one device, and the state is updated in place. Sampling noise is passed
in (``noise``, for parity with the JAX step's keys) or drawn from the
state's ``torch.Generator``.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Sequence

import torch

from sheeprl_tpu_torch.algos.dreamer_v2.agent import (
    actor_entropy,
    build_actor_dists,
    resolve_actor_distribution,
    sample_actor_actions,
)
from sheeprl_tpu_torch.algos.dreamer_v2.loss import reconstruction_loss
from sheeprl_tpu_torch.algos.dreamer_v2.utils import compute_lambda_values, normalize_obs_tensors
from sheeprl_tpu_torch.distributions import Bernoulli, Independent, Normal, gumbel_noise
from sheeprl_tpu_torch.utils.optim import Adam, clip_by_global_norm_

__all__ = ["build_optimizers_and_state", "build_train_fn", "draw_noise"]

_MODULES = ("world_model", "actor", "critic")


def build_optimizers_and_state(cfg, world_model, actor, critic, target_critic, generator=None) -> Dict[str, Any]:
    """The agent state a train step updates: the four modules, one optimizer
    per trained module (``utils.optim.Adam``: AdamW with the configured
    decoupled decay) and the generator noise is drawn from when the step is
    given none."""
    modules = {"world_model": world_model, "actor": actor, "critic": critic}
    opt = {}
    for name, module in modules.items():
        o = cfg.algo[name].optimizer
        opt[name] = Adam(module.parameters(), lr=float(o.lr), betas=tuple(o.betas), eps=float(o.eps),
                         weight_decay=float(o.weight_decay))
    return {**modules, "target_critic": target_critic, "opt": opt, "generator": generator}


def draw_noise(cfg, actions_dim: Sequence[int], T: int, B: int, generator: Optional[torch.Generator], device):
    """Gumbel(0,1) noise for one step: the posterior samples ``[T, B, S, D]``,
    the imagined priors ``[horizon, T·B, S, D]`` and each action head's
    samples ``[horizon, T·B, dim]``."""
    wm_cfg = cfg.algo.world_model
    S, D, horizon = int(wm_cfg.stochastic_size), int(wm_cfg.discrete_size), int(cfg.algo.horizon)
    draw = lambda *shape: gumbel_noise(shape, generator, device=device)
    return {
        "posterior": draw(T, B, S, D),
        "prior": draw(horizon, T * B, S, D),
        "actions": [draw(horizon, T * B, int(d)) for d in actions_dim],
    }


@contextlib.contextmanager
def _no_param_grads(*modules: torch.nn.Module):
    """Parameters of ``modules`` take no gradient inside the block."""
    params = [p for m in modules for p in m.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def _step(module: torch.nn.Module, optimizer: torch.optim.Optimizer, clip: float) -> torch.Tensor:
    """Clip the module's gradients (optax's global-norm form) and step; a
    parameter the loss did not reach gets a zero gradient, as in JAX, so the
    optimizer still decays it. Returns the gradient norm before clipping."""
    params = list(module.parameters())
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    norm = clip_by_global_norm_([p.grad for p in params], clip)
    optimizer.step()
    return norm


def build_train_fn(cfg, actions_dim: Sequence[int], is_continuous: bool):
    """Returns ``train_step(state, data, noise=None, tau=0.0) -> metrics``.

    ``state`` comes from :func:`build_optimizers_and_state`; ``data`` holds
    ``[T, B, ...]`` tensors on the modules' device: the observation keys
    (uint8 pixels ``[T, B, C, H, W]``), ``actions`` (one-hot), ``rewards``,
    ``dones`` and ``is_first`` (``[T, B, 1]``). ``noise`` is
    :func:`draw_noise`'s dict. The metrics are 0-dim device tensors under the
    JAX step's names."""
    if is_continuous:
        raise NotImplementedError("continuous actions are not ported yet")
    cnn_keys, mlp_keys = list(cfg.cnn_keys.encoder), list(cfg.mlp_keys.encoder)
    wm_cfg = cfg.algo.world_model
    S, D = int(wm_cfg.stochastic_size), int(wm_cfg.discrete_size)
    stoch_flat, rec_size = S * D, int(wm_cfg.recurrent_model.recurrent_state_size)
    horizon, gamma, lmbda = int(cfg.algo.horizon), float(cfg.algo.gamma), float(cfg.algo.lmbda)
    use_continues = bool(wm_cfg.use_continues)
    ent_coef, objective_mix = float(cfg.algo.actor.ent_coef), float(cfg.algo.actor.objective_mix)
    distribution = resolve_actor_distribution(cfg.distribution.get("type", "auto"), is_continuous)
    init_std, min_std = float(cfg.algo.actor.init_std), float(cfg.algo.actor.min_std)
    dims = [int(d) for d in actions_dim]
    clips = {name: float(cfg.algo[name].clip_gradients) for name in _MODULES}

    def world_model_loss(wm, data, gumbels):
        T, B = data["rewards"].shape[:2]
        batch_obs = normalize_obs_tensors({k: data[k] for k in cnn_keys + mlp_keys}, cnn_keys)
        is_first = data["is_first"].clone()
        is_first[0] = 1.0
        embedded = wm.encode(batch_obs)
        posterior = embedded.new_zeros((B, stoch_flat))
        recurrent = embedded.new_zeros((B, rec_size))
        recurrents, posteriors, post_logits = [], [], []
        for t in range(T):
            recurrent, posterior, logits = wm.rssm.dynamic_posterior(
                posterior, recurrent, data["actions"][t], embedded[t], is_first[t], gumbel=gumbels[t]
            )
            recurrents.append(recurrent)
            posteriors.append(posterior)
            post_logits.append(logits)
        recurrents, posteriors = torch.stack(recurrents), torch.stack(posteriors)
        prior_logits = wm.rssm.prior_logits(recurrents)
        latents = torch.cat([posteriors, recurrents], dim=-1)
        recon = wm.decode(latents)
        po = {k: Independent(Normal(recon[k], 1.0), 3 if k in cnn_keys else 1) for k in recon}
        pr = Independent(Normal(wm.reward(latents), 1.0), 1)
        pc = continue_targets = None
        if use_continues:
            pc = Independent(Bernoulli(logits=wm.continues(latents)), 1)
            continue_targets = (1.0 - data["dones"]) * gamma
        loss, metrics = reconstruction_loss(
            po, batch_obs, pr, data["rewards"],
            prior_logits.reshape(T, B, S, D), torch.stack(post_logits).reshape(T, B, S, D),
            float(wm_cfg.kl_balancing_alpha), float(wm_cfg.kl_free_nats), bool(wm_cfg.kl_free_avg),
            float(wm_cfg.kl_regularizer), pc, continue_targets, float(wm_cfg.discount_scale_factor),
        )
        return loss, metrics, posteriors.detach(), recurrents.detach()

    def imagination(wm, actor, posteriors, recurrents, prior_gumbels, action_gumbels):
        """``(trajectories [H+1, TB, L], actions [H+1, TB, A])`` with
        ``actions[0] = 0``; the action is computed inside the loop."""
        prior = posteriors.reshape(-1, stoch_flat)
        recurrent = recurrents.reshape(-1, rec_size)
        latent = latent0 = torch.cat([prior, recurrent], dim=-1)
        latents, actions = [], []
        for i in range(horizon):
            dists = build_actor_dists(actor(latent.detach()), is_continuous, distribution, init_std, min_std, 0.0)
            action = torch.cat(
                sample_actor_actions(dists, is_continuous, is_training=True, gumbels=[g[i] for g in action_gumbels]),
                dim=-1,
            )
            prior, recurrent = wm.rssm.imagination(prior, recurrent, action, gumbel=prior_gumbels[i])
            latent = torch.cat([prior, recurrent], dim=-1)
            latents.append(latent)
            actions.append(action)
        trajectories = torch.cat([latent0[None], torch.stack(latents)])
        return trajectories, torch.cat([torch.zeros_like(actions[0])[None], torch.stack(actions)])

    def actor_loss(wm, actor, target_critic, posteriors, recurrents, true_continue, noise):
        traj, imagined_actions = imagination(wm, actor, posteriors, recurrents, noise["prior"], noise["actions"])
        predicted_values = target_critic(traj)
        predicted_rewards = wm.reward(traj)
        if use_continues:
            continues = torch.sigmoid(wm.continues(traj))
            continues = torch.cat([true_continue[None] * gamma, continues[1:]])
        else:
            continues = torch.ones_like(predicted_rewards.detach()) * gamma
        lambda_values = compute_lambda_values(
            predicted_rewards[:-1], predicted_values[:-1], continues[:-1], bootstrap=predicted_values[-1:], lmbda=lmbda
        )
        discount = torch.cumprod(torch.cat([torch.ones_like(continues[:1]), continues[:-1]]), dim=0).detach()
        policies = build_actor_dists(actor(traj[:-2].detach()), is_continuous, distribution, init_std, min_std, 0.0)
        dynamics = lambda_values[1:]
        advantage = (lambda_values[1:] - predicted_values[:-2]).detach()
        per_head = [
            p.log_prob(a[1:-1].detach())[..., None]
            for p, a in zip(policies, torch.split(imagined_actions, dims, dim=-1))
        ]
        reinforce = sum(per_head) * advantage
        objective = objective_mix * reinforce + (1 - objective_mix) * dynamics
        entropy = ent_coef * actor_entropy(policies)
        policy_loss = -torch.mean(discount[:-2] * (objective + entropy[..., None]))
        aux = {
            "trajectories": traj.detach(),
            "lambda_values": lambda_values.detach(),
            "discount": discount,
            "User/PredictedRewards": predicted_rewards.detach().mean(),
            "User/LambdaValues": lambda_values.detach().mean(),
        }
        return policy_loss, aux

    def critic_loss(critic, traj, lambda_values, discount):
        qv = Independent(Normal(critic(traj[:-1]), 1.0), 1)
        return -torch.mean(discount[:-1, ..., 0] * qv.log_prob(lambda_values))

    def train_step(state: Dict[str, Any], data: Dict[str, torch.Tensor], noise=None, tau: float = 0.0):
        wm, actor, critic, target = state["world_model"], state["actor"], state["critic"], state["target_critic"]
        opt = state["opt"]
        T, B = data["rewards"].shape[:2]
        if noise is None:
            noise = draw_noise(cfg, dims, T, B, state.get("generator"), data["rewards"].device)

        with torch.no_grad():  # the target chosen by tau before any update
            if tau:
                for t_p, c_p in zip(target.parameters(), critic.parameters()):
                    t_p.copy_(tau * c_p + (1.0 - tau) * t_p)

        for o in opt.values():
            o.zero_grad(set_to_none=True)
        wm_loss, metrics, posteriors, recurrents = world_model_loss(wm, data, noise["posterior"])
        wm_loss.backward()
        grad_norms = {"world_model": _step(wm, opt["world_model"], clips["world_model"])}

        true_continue = (1.0 - data["dones"]).reshape(-1, 1)
        with _no_param_grads(wm, target):
            policy_loss, aux = actor_loss(wm, actor, target, posteriors, recurrents, true_continue, noise)
            policy_loss.backward()
        grad_norms["actor"] = _step(actor, opt["actor"], clips["actor"])

        value_loss = critic_loss(critic, aux["trajectories"], aux["lambda_values"], aux["discount"])
        value_loss.backward()
        grad_norms["critic"] = _step(critic, opt["critic"], clips["critic"])

        metrics = dict(metrics)
        metrics["Loss/policy_loss"] = policy_loss.detach()
        metrics["User/PredictedRewards"] = aux["User/PredictedRewards"]
        metrics["User/LambdaValues"] = aux["User/LambdaValues"]
        metrics["Loss/value_loss"] = value_loss.detach()
        metrics.update({f"Grads/{name}": norm for name, norm in grad_norms.items()})
        return metrics

    return train_step


"""DroQ training (counterpart of ``sheeprl_tpu/algos/droq/droq.py``): SAC
with a dropout-regularized critic ensemble at a high replay ratio.

One update's program, as the JAX one:

1. ``per_rank_gradient_steps`` (G) critic steps, each on its own batch: the
   TD target of the dropout target critics at the actor's sample of the
   next observation (min over the members less ``alpha · log_prob``), the
   members' summed MSE under fresh dropout masks, one Adam step of all
   members, and the target EMA at ``algo.tau`` after every step;
2. one actor step on a separate batch, against the ensemble's **mean** Q
   under dropout; then ``log_alpha``'s step.

The whole update, the G-step critic loop included, is one function over
static buffers (the ``[G, B, ...]`` critic batch, the actor batch, the
samples' normals and every dropout mask, drawn outside the graph), so on
the card it is one CUDA graph replay an update. Its metrics are the mean
critic loss over the G steps, the actor's and alpha's losses.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from sheeprl_tpu_torch.algos.droq.agent import DROQCritic, draw_dropout_masks
from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import _no_param_grads, read_resume_checkpoint
from sheeprl_tpu_torch.algos.sac import sac
from sheeprl_tpu_torch.algos.sac.agent import SACActor, lecun_normal_, squash_sample
from sheeprl_tpu_torch.algos.sac.loss import policy_loss
from sheeprl_tpu_torch.algos.sac.sac import StepProgram, actor_and_alpha_update, ema_gates, ema_update
from sheeprl_tpu_torch.obs.learn import learn_tap, probe_losses, probe_optimizer, probe_record
from sheeprl_tpu_torch.utils.registry import register_algorithm

__all__ = ["build_agent_state", "build_train_fn", "main"]

_MODULES = ("actor", "critics", "target_critics")


def build_agent_state(obs_dim: int, act_dim: int, cfg, generator: Optional[torch.Generator], device=None) -> dict:
    """The actor, the dropout critics, their target (a copy) and ``log_alpha``."""
    hidden, n, p = int(cfg.algo.critic.hidden_size), int(cfg.algo.critic.n), float(cfg.algo.critic.dropout)
    actor = lecun_normal_(SACActor(obs_dim, act_dim, int(cfg.algo.actor.hidden_size)), generator)
    critics = lecun_normal_(DROQCritic(n, obs_dim + act_dim, hidden, p), generator)
    targets = DROQCritic(n, obs_dim + act_dim, hidden, p)
    targets.load_state_dict(critics.state_dict())
    targets.requires_grad_(False)
    log_alpha = torch.log(torch.tensor([float(cfg.algo.alpha.alpha)], dtype=torch.float32))
    return {
        "actor": actor.to(device),
        "critics": critics.to(device),
        "target_critics": targets.to(device),
        "log_alpha": torch.nn.Parameter(log_alpha.to(device)),
    }


def build_train_fn(cfg, act_dim: int, target_entropy: float) -> StepProgram:
    """The update as a :class:`~sheeprl_tpu_torch.algos.sac.sac.StepProgram`.
    ``data`` holds the critic batch ``[G, B, ...]`` (``observations``,
    ``actions``, ``rewards``, ``dones``, ``next_observations``) and the
    actor batch's ``actor_observations`` ``[B, obs_dim]``; ``noise`` holds
    ``next`` ``[G, B, A]``, ``target_masks`` and ``masks`` ``[G, layers, n,
    B, hidden]``, ``actor`` ``[B, A]`` and ``actor_masks`` ``[layers, n, B,
    hidden]``; ``gates`` is ``ema_gates(True, tau)``."""
    gamma = float(cfg.algo.gamma)
    n_critics = int(cfg.algo.critic.n)

    def body(state, data, noise, gates):
        actor, critics, targets, log_alpha, opt = (state[k] for k in ("actor", "critics", "target_critics",
                                                                       "log_alpha", "opt"))
        scale, bias = state["action_scale"], state["action_bias"]
        sac._zero_grads([p for m in (actor, critics) for p in m.parameters()] + [log_alpha])
        alpha = torch.exp(log_alpha.detach())
        qf_losses = []
        for i in range(data["rewards"].shape[0]):
            with torch.no_grad():
                next_mean, next_std = actor(data["next_observations"][i])
                next_actions, next_logprob = squash_sample(next_mean, next_std, noise["next"][i], scale, bias)
                target_q = targets(data["next_observations"][i], next_actions, noise["target_masks"][i])
                min_target = torch.amin(target_q, dim=-1, keepdim=True) - alpha * next_logprob
                td_target = data["rewards"][i] + (1.0 - data["dones"][i]) * gamma * min_target
            q = critics(data["observations"][i], data["actions"][i], noise["masks"][i])
            qf_loss = sum(((q[..., j : j + 1] - td_target) ** 2).mean() for j in range(n_critics))
            if i > 0:
                sac._zero_grads(list(critics.parameters()))
            qf_loss.backward()
            probed = probe_optimizer("critic", opt["qf"])
            opt["qf"].step()
            probed()
            probe_record(qf_loss)
            ema_update(targets, critics, gates[0], gates[1])
            qf_losses.append(qf_loss.detach())

        def actor_loss_fn():
            mean, std = actor(data["actor_observations"])
            actions, logprob = squash_sample(mean, std, noise["actor"], scale, bias)
            with _no_param_grads(critics):
                mean_q = critics(data["actor_observations"], actions, noise["actor_masks"]).mean(-1, keepdim=True)
            return policy_loss(alpha, logprob, mean_q), logprob

        actor_loss, alpha_loss = actor_and_alpha_update(state, actor_loss_fn, alpha, target_entropy)
        probe_losses(actor_loss, alpha_loss)
        return torch.stack([torch.stack(qf_losses).mean(), actor_loss, alpha_loss])

    def draw_noise(state, data, generator, device):
        g, batch = data["rewards"].shape[:2]
        critics = state["critics"]
        return {
            "next": torch.randn((g, batch, act_dim), generator=generator, device=device),
            "target_masks": draw_dropout_masks(critics, batch, generator, device, (g,)),
            "masks": draw_dropout_masks(critics, batch, generator, device, (g,)),
            "actor": torch.randn((batch, act_dim), generator=generator, device=device),
            "actor_masks": draw_dropout_masks(critics, batch, generator, device),
        }

    return StepProgram(body, draw_noise, sac._prepare, n_gates=2, learn_tap=learn_tap())


def droq_train_round(cfg, program: StepProgram, state: Dict[str, Any]):
    """DroQ's updates ``first..last``: after ``learning_starts``, each one
    G critic steps on a ``[G, B]`` sample and one actor step on a ``[B]``
    sample, one program call (no catch-up burst)."""
    per_rank_gradient_steps = int(cfg.algo.per_rank_gradient_steps)
    gates = ema_gates(True, float(cfg.algo.tau))

    def train_round(staging, first: int, last: int, learning_starts: int, counters) -> Optional[torch.Tensor]:
        metrics = None
        for u in range(first, last + 1):
            if u <= learning_starts:
                continue
            critic_batch = staging.sample_device(cfg.per_rank_batch_size, n_samples=per_rank_gradient_steps,
                                                 sample_next_obs=cfg.buffer.sample_next_obs)
            actor_batch = staging.sample_device(cfg.per_rank_batch_size)
            data = {k: v[None] for k, v in critic_batch.items()}
            data["actor_observations"] = actor_batch["observations"]
            metrics = program.burst(state, data, gates)
            counters["gradient_steps"] += per_rank_gradient_steps
            counters["ema_steps"] += per_rank_gradient_steps
            counters["actor_steps"] = counters.get("actor_steps", 0) + 1
            counters["train_bursts"] += 1
        return metrics

    return train_round


@register_algorithm()
def main(fabric, cfg) -> Dict[str, Any]:
    """The DroQ training run (SAC's loop, the Python plane only)."""
    run = sac.open_run(fabric, cfg, "DroQ")
    obs_dim = sac.check_vector_obs(cfg, run.observation_space, "DroQ")
    act_dim = run.act_dim
    agent = build_agent_state(obs_dim, act_dim, cfg, torch.Generator().manual_seed(int(cfg.seed)), run.device)
    state = sac.build_optimizers_and_state(cfg, agent, generator=run.generator)
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
        obs_rows=sac.vector_rows(cfg),
        stored_keys=("observations",),
        acting_policy=sac.sac_acting_policy(state),
        train_round=droq_train_round(cfg, program, state),
        loss_names=sac.LOSS_NAMES,
        checkpoint_state=checkpoint_state,
        publish=lambda: {"agent": {"actor": state["actor"].state_dict()}},
        greedy=sac.sac_greedy(state, cfg),
        programs=[program],
    )

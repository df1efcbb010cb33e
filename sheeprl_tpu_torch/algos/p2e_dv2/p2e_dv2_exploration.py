"""Plan2Explore on DreamerV2, the exploration phase (counterpart of
``sheeprl_tpu/algos/p2e_dv2/p2e_dv2_exploration.py``): the gradient step
and the training run (:func:`main`, registered as ``p2e_dv2_exploration``).

One gradient step makes six updates, in the JAX step's order:

1. the targets of the task and exploration critics chosen by ``τ`` ∈ {0, 1}
   (a hard copy of the critic, or unchanged), before any update;
2. the world model, DreamerV2's loss; its update;
3. the ensemble: each member regresses the next posterior from
   ``(posterior_t, recurrent_t, action_t)`` (the action that led to row t,
   as DreamerV2 stores it) under a unit Gaussian
   (``Independent(Normal(out, 1), 1)``), the output's last step dropped;
   its update (clip ``algo.ensembles.clip_gradients``);
4. the exploration actor, on the updated world model and ensemble:
   DreamerV2's imagination with the exploration actor, the reward the
   ensemble's population variance over members of the predicted next state
   (averaged over its width, times ``intrinsic_reward_multiplier``, no
   gradient), the exploration target critic's values, λ-returns, and the
   REINFORCE objective (discrete actions) or the λ-returns themselves
   (continuous: dynamics backprop) with entropy; its update;
5. the exploration critic against those λ-returns; its update;
6. the task actor and critic: the same losses with the reward head's mean and
   the task target critic.

The step is graph-safe like DreamerV2's (a burst replays it from one CUDA
graph a step on the card). The run (:func:`main`) is DreamerV2's loop
(``dreamer_v2.train_loop``, the sequential buffer) acting with the
exploration actor; its checkpoint holds every module and optimizer state
under the JAX names, and its test episode plays the task actor.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_v2 import dreamer_v2 as dv2
from sheeprl_tpu_torch.algos.dreamer_v2.agent import (
    actor_entropy,
    actor_noise,
    build_actor_dists,
    resolve_actor_distribution,
)
from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import (
    _no_param_grads,
    _step,
    adam_for,
    give_zero_grads,
    load_optimizer_state,
)
from sheeprl_tpu_torch.algos.dreamer_v2.utils import compute_lambda_values
from sheeprl_tpu_torch.algos.p2e_dv2.agent import build_agent, build_player_fns
from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_exploration import ensemble_loss, intrinsic_reward
from sheeprl_tpu_torch.distributions import Independent, Normal, gumbel_noise
from sheeprl_tpu_torch.obs.learn import learn_tap, probe_losses
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

#: the modules with their own optimizer
_TRAINED = ("world_model", "ensembles", "actor_exploration", "critic_exploration", "actor_task", "critic_task")
_MODULES = _TRAINED + ("target_critic_task", "target_critic_exploration")


def build_optimizers_and_state(cfg, world_model, actor_task, critic_task, target_critic_task, actor_exploration,
                               critic_exploration, target_critic_exploration, ensembles, generator=None):
    """The agent state a step updates: the modules, one ``Adam`` per trained
    module (the ensemble's at ``algo.ensembles.optimizer``, the exploration
    actor's and critic's at the task actor's and critic's settings) and the
    generator noise is drawn from when the step is given none."""
    modules = dict(
        world_model=world_model, actor_task=actor_task, critic_task=critic_task,
        target_critic_task=target_critic_task, actor_exploration=actor_exploration,
        critic_exploration=critic_exploration, target_critic_exploration=target_critic_exploration,
        ensembles=ensembles,
    )
    groups = {"world_model": cfg.algo.world_model, "ensembles": cfg.algo.ensembles, "actor_task": cfg.algo.actor,
              "critic_task": cfg.algo.critic, "actor_exploration": cfg.algo.actor,
              "critic_exploration": cfg.algo.critic}
    opt = {name: adam_for(modules[name], group.optimizer) for name, group in groups.items()}
    return {**modules, "opt": opt, "generator": generator}


def prepare(state: Dict[str, Any]) -> None:
    """``give_zero_grads`` to every trained module."""
    give_zero_grads(state[name] for name in _TRAINED)


def draw_noise(cfg, actions_dim: Sequence[int], T: int, B: int, generator: Optional[torch.Generator], device,
               is_continuous: bool = False) -> Dict[str, Any]:
    """DreamerV2's step noise (``posterior``, and the task actor's imagination
    ``prior`` and ``actions``) and the exploration actor's imagination's
    (``exploration_prior`` ``[horizon, T·B, S, D]``, ``exploration_actions``
    ``[horizon, T·B, dim]`` a head)."""
    noise = dv2.draw_noise(cfg, actions_dim, T, B, generator, device, is_continuous)
    wm_cfg = cfg.algo.world_model
    S, D, horizon = int(wm_cfg.stochastic_size), int(wm_cfg.discrete_size), int(cfg.algo.horizon)
    distribution = resolve_actor_distribution(cfg.distribution.get("type", "auto"), is_continuous)
    heads = [int(np.sum(actions_dim))] if is_continuous else [int(d) for d in actions_dim]
    noise["exploration_prior"] = gumbel_noise((horizon, T * B, S, D), generator, device=device)
    noise["exploration_actions"] = [actor_noise(distribution, (horizon, T * B, d), generator, device) for d in heads]
    return noise


def _normal_log_prob(out, target):
    return Independent(Normal(out, 1.0), 1).log_prob(target)


def build_losses(cfg, actions_dim: Sequence[int], is_continuous: bool) -> SimpleNamespace:
    """DreamerV2's ``world_model_loss`` and ``critic_loss`` and the P2E
    losses: ``ensemble_loss(ensembles, posteriors, recurrents, actions)`` and
    ``behaviour_loss_backward(wm, actor, target_critic, posteriors,
    recurrents, true_continue, prior_gumbels, action_noise, reward_fn) ->
    (loss, aux)``, one actor's loss differentiated in the actor alone, with
    ``reward_fn(trajectories, actions)`` its reward; the clip norms."""
    losses = dv2.build_losses(cfg, actions_dim, is_continuous)
    wm_cfg = cfg.algo.world_model
    gamma, lmbda = float(cfg.algo.gamma), float(cfg.algo.lmbda)
    use_continues = bool(wm_cfg.use_continues)
    ent_coef = float(cfg.algo.actor.ent_coef)
    distribution = resolve_actor_distribution(cfg.distribution.get("type", "auto"), is_continuous)
    init_std, min_std = float(cfg.algo.actor.init_std), float(cfg.algo.actor.min_std)
    dims = [int(d) for d in actions_dim]
    clips = dict(losses.clips)
    clips["ensembles"] = float(cfg.algo.ensembles.clip_gradients)

    def behaviour_loss(wm, actor, target_critic, posteriors, recurrents, true_continue, prior_gumbels, action_noise,
                       reward_fn):
        with torch.set_grad_enabled(is_continuous):
            traj, imagined_actions = losses.imagination(wm, actor, posteriors, recurrents, prior_gumbels, action_noise)
            predicted_values = target_critic(traj)
            reward = reward_fn(traj, imagined_actions)
            if use_continues:
                continues = torch.sigmoid(wm.continues(traj))
                continues = torch.cat([true_continue[None] * gamma, continues[1:]])
            else:
                continues = torch.ones_like(reward.detach()) * gamma
            lambda_values = compute_lambda_values(
                reward[:-1], predicted_values[:-1], continues[:-1], bootstrap=predicted_values[-1:], lmbda=lmbda
            )
            discount = torch.cumprod(torch.cat([torch.ones_like(continues[:1]), continues[:-1]]), dim=0).detach()
        policies = build_actor_dists(actor(traj[:-2].detach()), is_continuous, distribution, init_std, min_std, 0.0)
        if is_continuous:
            objective = lambda_values[1:]
        else:
            advantage = (lambda_values[1:] - predicted_values[:-2]).detach()
            per_head = [
                p.log_prob(a[1:-1].detach())[..., None]
                for p, a in zip(policies, torch.split(imagined_actions, dims, dim=-1))
            ]
            objective = sum(per_head) * advantage
        entropy = ent_coef * actor_entropy(policies, distribution)
        policy_loss = -torch.mean(discount[:-2] * (objective + entropy[..., None]))
        aux = {"trajectories": traj.detach(), "lambda_values": lambda_values.detach(), "discount": discount,
               "reward_mean": reward.detach().mean(), "values_mean": predicted_values.detach().mean()}
        return policy_loss, aux

    def behaviour_loss_backward(wm, actor, target_critic, *args):
        with _no_param_grads(wm, target_critic):
            policy_loss, aux = behaviour_loss(wm, actor, target_critic, *args)
            policy_loss.backward()
        return policy_loss, aux

    def _ensemble_loss(ensembles, posteriors, recurrents, actions):
        return ensemble_loss(ensembles, posteriors, recurrents, actions, _normal_log_prob)

    return SimpleNamespace(
        world_model_loss=losses.world_model_loss, critic_loss=losses.critic_loss, ensemble_loss=_ensemble_loss,
        behaviour_loss=behaviour_loss, behaviour_loss_backward=behaviour_loss_backward, clips=clips,
    )


def build_train_fn(cfg, actions_dim: Sequence[int], is_continuous: bool) -> TrainProgram:
    """The exploration phase's gradient step as a
    :class:`~sheeprl_tpu_torch.train.burst.TrainProgram` over
    :func:`build_optimizers_and_state`'s state (the six updates of the
    module's docstring); ``data`` and the metrics as DreamerV2's step has
    them, the metrics under the JAX step's names; ``noise`` is
    :func:`draw_noise`'s dict."""
    losses = build_losses(cfg, actions_dim, is_continuous)
    clips = losses.clips
    multiplier = float(cfg.algo.intrinsic_reward_multiplier)

    def body(state: Dict[str, Any], data: Dict[str, torch.Tensor], noise, tau: torch.Tensor):
        wm, ens, opt = state["world_model"], state["ensembles"], state["opt"]
        with torch.no_grad():  # the targets chosen by tau before any update
            targets = list(state["target_critic_task"].parameters()) + list(
                state["target_critic_exploration"].parameters()
            )
            sources = list(state["critic_task"].parameters()) + list(state["critic_exploration"].parameters())
            torch._foreach_mul_(targets, 1.0 - tau)
            torch._foreach_add_(targets, torch._foreach_mul(sources, tau))
            torch._foreach_zero_([p.grad for name in _TRAINED for p in state[name].parameters()])

        wm_loss, metrics, posteriors, recurrents = losses.world_model_loss(wm, data, noise["posterior"])
        wm_loss.backward()
        grads = {"world_model": _step(wm, opt["world_model"], clips["world_model"], "world_model")}

        ens_loss = losses.ensemble_loss(ens, posteriors, recurrents, data["actions"])
        ens_loss.backward()
        grads["ensemble"] = _step(ens, opt["ensembles"], clips["ensembles"], "ensembles")

        true_continue = (1.0 - data["dones"]).reshape(-1, 1)
        policy_expl, aux_expl = losses.behaviour_loss_backward(
            wm, state["actor_exploration"], state["target_critic_exploration"], posteriors, recurrents,
            true_continue, noise["exploration_prior"], noise["exploration_actions"],
            lambda traj, actions: intrinsic_reward(ens, traj.detach(), actions.detach(), multiplier),
        )
        grads["actor_exploration"] = _step(state["actor_exploration"], opt["actor_exploration"], clips["actor"],
                                           "actor_exploration")
        value_expl = losses.critic_loss(state["critic_exploration"], aux_expl["trajectories"],
                                        aux_expl["lambda_values"], aux_expl["discount"])
        value_expl.backward()
        grads["critic_exploration"] = _step(state["critic_exploration"], opt["critic_exploration"], clips["critic"],
                                            "critic_exploration")

        policy_task, aux_task = losses.behaviour_loss_backward(
            wm, state["actor_task"], state["target_critic_task"], posteriors, recurrents, true_continue,
            noise["prior"], noise["actions"], lambda traj, actions: wm.reward(traj),
        )
        grads["actor_task"] = _step(state["actor_task"], opt["actor_task"], clips["actor"], "actor_task")
        value_task = losses.critic_loss(state["critic_task"], aux_task["trajectories"], aux_task["lambda_values"],
                                        aux_task["discount"])
        value_task.backward()
        grads["critic_task"] = _step(state["critic_task"], opt["critic_task"], clips["critic"], "critic_task")
        probe_losses(wm_loss, ens_loss, policy_expl, value_expl, policy_task, value_task)

        metrics = dict(metrics)
        metrics["Loss/ensemble_loss"] = ens_loss.detach()
        metrics["Loss/policy_loss_exploration"] = policy_expl.detach()
        metrics["Loss/value_loss_exploration"] = value_expl.detach()
        metrics["Loss/policy_loss_task"] = policy_task.detach()
        metrics["Loss/value_loss_task"] = value_task.detach()
        metrics["Rewards/intrinsic"] = aux_expl["reward_mean"]
        metrics["Values_exploration/predicted_values"] = aux_expl["values_mean"]
        metrics["Values_exploration/lambda_values"] = aux_expl["lambda_values"].mean()
        metrics.update({f"Grads/{name}": norm for name, norm in grads.items()})
        return metrics

    def noise_for(T: int, B: int, generator: Optional[torch.Generator], device):
        return draw_noise(cfg, actions_dim, T, B, generator, device, is_continuous)

    return build_train_burst(body, noise_for, prepare, learn_tap())


# ---------------------------------------------------------------------------
# the training run
# ---------------------------------------------------------------------------


def agent_state_dict(state: Dict[str, Any]) -> Dict[str, Any]:
    """The checkpoint's ``agent`` tree under the JAX names: each module's
    ``state_dict`` and each optimizer's per-parameter state."""
    out: Dict[str, Any] = {name: state[name].state_dict() for name in _MODULES}
    out["opt"] = {name: {"state": o.state_dict()["state"]} for name, o in state["opt"].items()}
    return out


def load_agent_state(state: Dict[str, Any], agent: Dict[str, Any]) -> None:
    """Load an :func:`agent_state_dict` tree (numpy leaves) into ``state`` in place."""
    for name in _MODULES:
        state[name].load_state_dict({k: torch.as_tensor(v) for k, v in agent[name].items()})
    for name, o in state["opt"].items():
        load_optimizer_state(o, agent["opt"][name])


@register_algorithm()
def main(fabric, cfg) -> Dict[str, Any]:
    """The exploration run: DreamerV2's loop acting with the exploration
    actor, the six-update step, a checkpoint of every module, and a test
    episode of the task actor. Returns the loop's result."""
    dv2._unsupported(cfg)
    # the exploration phase always acts with the exploration actor; these env settings cannot be changed
    cfg.algo.player.actor_type = "exploration"
    cfg.env.screen_size = 64
    cfg.env.frame_stack = 1
    run = dv2.open_run(fabric, cfg)
    modules = build_agent(cfg, run.actions_dim, run.is_continuous, run.observation_space.spaces, seed=cfg.seed,
                          device=run.device)
    state = build_optimizers_and_state(cfg, *modules, generator=run.generator)
    resumed = dv2.read_resume_checkpoint(fabric, cfg)
    if resumed is not None:
        load_agent_state(state, resumed["agent"])
    wm = state["world_model"]
    players = {name: build_player_fns(wm, state[name], cfg, run.actions_dim, run.is_continuous)
               for name in ("actor_exploration", "actor_task")}
    return dv2.train_loop(
        fabric, cfg, run, state, build_train_fn(cfg, run.actions_dim, run.is_continuous), resumed,
        players=[players["actor_exploration"]],
        checkpoint_state=lambda: {"agent": agent_state_dict(state)},
        publish=lambda: {"agent": {"world_model": wm.state_dict(), "actor_task": state["actor_task"].state_dict()}},
        test_player=players["actor_task"],
        buffer_kind="sequential",
        replay_state=resumed.get("rb") if resumed is not None and cfg.buffer.get("checkpoint", False) else None,
    )

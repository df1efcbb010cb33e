"""Plan2Explore on DreamerV3, the exploration phase (counterpart of
``sheeprl_tpu/algos/p2e_dv3/p2e_dv3_exploration.py``): the gradient step
(``build_train_fn``, ``build_optimizers_and_state``) and the training run
(:func:`main`, registered as ``p2e_dv3_exploration``).

One gradient step makes six updates, in the JAX step's order:

1. the EMA targets ``t ← τ·c + (1−τ)·t`` of the task critic and of every
   exploration critic, before any update;
2. the world model, DreamerV3's loss; its update;
3. the ensemble: each member regresses the next posterior from
   ``(posterior_t, recurrent_t, action_t)`` (the action taken at row t, as
   DreamerV3 stores it: unshifted) under an MSE, the output's last step
   dropped; its update (clip ``algo.ensembles.clip_gradients``);
4. the exploration actor, on the updated world model and ensemble: a
   ``horizon``-step imagination with the exploration actor; per exploration
   critic its reward (``intrinsic``: the ensemble's population variance over
   members of the predicted next state, averaged over the state's width,
   times ``intrinsic_reward_multiplier``; ``task``: the reward head's two-hot
   mean), its λ-returns and its own ``Moments``; the advantage the sum of the
   per-critic normalized advantages weighted by ``weight / Σ weights``; the
   REINFORCE or dynamics-backprop objective with entropy; its update;
5. each exploration critic against its λ-returns and its target's values on
   the exploration trajectories; its update;
6. the task actor and the task critic: DreamerV3's actor and critic losses on
   their own imagination.

The ensemble's input on the imagined trajectories is detached, so the
intrinsic reward passes no gradient; with continuous actions the actor's
gradient runs back through the imagination from the critics' values and the
reward head. Each actor loss is differentiated in its actor alone (the world
model and the critics take no gradient meanwhile).

Like DreamerV3's, the step is graph-safe (the noise an input, the targets a
lerp by a device ``τ``, everything updated in place), so a burst replays it
from one CUDA graph a step on the card. The run (:func:`main`) is DreamerV3's
loop (``dreamer_v3.train_loop``) acting with the exploration actor; its
checkpoint holds every module, optimizer and ``Moments`` state under the JAX
names, and its test episode plays the task actor.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import (
    _no_param_grads,
    _step,
    adam_for,
    give_zero_grads,
    load_optimizer_state,
    read_resume_checkpoint,
)
from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
from sheeprl_tpu_torch.algos.dreamer_v3.agent import (
    actor_entropy,
    actor_noise,
    build_actor_dists,
    resolve_actor_distribution,
)
from sheeprl_tpu_torch.algos.dreamer_v3.loss import continue_distribution
from sheeprl_tpu_torch.algos.dreamer_v3.utils import compute_lambda_values, init_moments, update_moments
from sheeprl_tpu_torch.algos.p2e_dv3.agent import build_agent, build_player_fns
from sheeprl_tpu_torch.distributions import MSEDistribution, TwoHotEncodingDistribution, gumbel_noise
from sheeprl_tpu_torch.train.burst import TrainProgram, build_train_burst
from sheeprl_tpu_torch.utils.registry import register_algorithm

__all__ = [
    "agent_state_dict",
    "build_losses",
    "build_optimizers_and_state",
    "build_train_fn",
    "draw_noise",
    "ensemble_loss",
    "intrinsic_reward",
    "load_agent_state",
    "main",
    "trained_modules",
]

#: the modules with their own optimizer, besides the exploration critics
_TRAINED = ("world_model", "ensembles", "actor_exploration", "actor_task", "critic_task")
_MODULES = _TRAINED + ("target_critic_task",)


def build_optimizers_and_state(cfg, world_model, actor_task, critic_task, target_critic_task, actor_exploration,
                               critics_exploration, ensembles, generator=None) -> Dict[str, Any]:
    """The agent state a step updates: the modules (``critics_exploration``
    ``{name: {"module", "target"}}``), one ``Adam`` per trained module (the
    ensemble's at ``algo.ensembles.optimizer``, the exploration actor's and
    critics' at the task actor's and critic's settings), the ``Moments``
    states ``{"task", "exploration": {name}}`` and the generator noise is
    drawn from when the step is given none."""
    device = next(world_model.parameters()).device
    opt = {
        "world_model": adam_for(world_model, cfg.algo.world_model.optimizer),
        "ensembles": adam_for(ensembles, cfg.algo.ensembles.optimizer),
        "actor_task": adam_for(actor_task, cfg.algo.actor.optimizer),
        "critic_task": adam_for(critic_task, cfg.algo.critic.optimizer),
        "actor_exploration": adam_for(actor_exploration, cfg.algo.actor.optimizer),
        "critics_exploration": {k: adam_for(c["module"], cfg.algo.critic.optimizer)
                                for k, c in critics_exploration.items()},
    }
    return {
        "world_model": world_model, "actor_task": actor_task, "critic_task": critic_task,
        "target_critic_task": target_critic_task, "actor_exploration": actor_exploration,
        "critics_exploration": critics_exploration, "ensembles": ensembles, "opt": opt,
        "moments": {"task": init_moments(device), "exploration": {k: init_moments(device) for k in critics_exploration}},
        "generator": generator,
    }


def trained_modules(state: Dict[str, Any]) -> Dict[str, torch.nn.Module]:
    """Every module with an optimizer, the exploration critics as
    ``critics_exploration.<name>``."""
    out = {name: state[name] for name in _TRAINED}
    for k, c in state["critics_exploration"].items():
        out[f"critics_exploration.{k}"] = c["module"]
    return out


def prepare(state: Dict[str, Any]) -> None:
    """``give_zero_grads`` to every trained module."""
    give_zero_grads(trained_modules(state).values())


def draw_noise(cfg, actions_dim: Sequence[int], T: int, B: int, generator: Optional[torch.Generator], device,
               is_continuous: bool = False) -> Dict[str, Any]:
    """DreamerV3's step noise (``posterior``, and the task actor's imagination
    ``prior`` and ``actions``) and the exploration actor's imagination's
    (``exploration_prior`` ``[horizon, T·B, S, D]``, ``exploration_actions``
    ``[horizon + 1, T·B, dim]`` a head)."""
    noise = dv3.draw_noise(cfg, actions_dim, T, B, generator, device, is_continuous)
    wm_cfg = cfg.algo.world_model
    S, D, horizon = int(wm_cfg.stochastic_size), int(wm_cfg.discrete_size), int(cfg.algo.horizon)
    distribution = resolve_actor_distribution(cfg.distribution.get("type", "auto"), is_continuous)
    heads = [int(np.sum(actions_dim))] if is_continuous else [int(d) for d in actions_dim]
    noise["exploration_prior"] = gumbel_noise((horizon, T * B, S, D), generator, device=device)
    noise["exploration_actions"] = [actor_noise(distribution, (horizon + 1, T * B, d), generator, device)
                                    for d in heads]
    return noise


def ensemble_loss(ensembles, posteriors, recurrents, actions, log_prob) -> torch.Tensor:
    """``−Σ_members mean_{t,b} log_prob(out, posteriors[1:])``: each member
    predicts the next posterior from ``[posterior_t, recurrent_t,
    action_t]``, its last step dropped. ``log_prob(out, target)`` is the
    family's: an MSE (DreamerV3) or a unit Gaussian (DreamerV2)."""
    out = ensembles(torch.cat([posteriors, recurrents, actions], dim=-1))[:, :-1]
    lp = log_prob(out, posteriors[1:][None])
    return -torch.sum(torch.mean(lp, dim=tuple(range(1, out.dim() - 1))))


def intrinsic_reward(ensembles, trajectories, actions, multiplier: float) -> torch.Tensor:
    """The disagreement of the ensemble on ``[trajectories, actions]``: the
    population variance over members (ddof 0, as ``jnp.var``) of each
    predicted element, averaged over the state's width, times
    ``multiplier``; ``[..., 1]``. No gradient."""
    with torch.no_grad():
        pred = ensembles(torch.cat([trajectories, actions], dim=-1))
        return torch.var(pred, dim=0, correction=0).mean(-1, keepdim=True) * multiplier


def _mse_log_prob(out, target):
    return MSEDistribution(out, dims=1).log_prob(target)


def build_losses(cfg, actions_dim: Sequence[int], is_continuous: bool) -> SimpleNamespace:
    """DreamerV3's losses (``world_model_loss``, ``imagination``,
    ``actor_loss_backward`` of the task actor, ``critic_loss``) and the
    exploration phase's: ``ensemble_loss(ensembles, posteriors, recurrents,
    actions)`` and ``exploration_actor_loss(wm, actor, ensembles, critics,
    moments, posteriors, recurrents, true_continue, noise) -> (loss, aux)``
    (``critics`` the exploration critics' modules by name, ``moments`` their
    ``Moments`` states; ``aux`` the trajectories, the discount, each critic's
    λ-returns and new ``Moments`` and the metrics), with
    ``exploration_actor_loss_backward`` differentiating it in the actor
    alone, and the clip norms."""
    losses = dv3.build_losses(cfg, actions_dim, is_continuous)
    gamma, lmbda = float(cfg.algo.gamma), float(cfg.algo.lmbda)
    ent_coef = float(cfg.algo.actor.ent_coef)
    distribution = resolve_actor_distribution(cfg.distribution.get("type", "auto"), is_continuous)
    init_std, min_std = float(cfg.algo.actor.init_std), float(cfg.algo.actor.min_std)
    unimix = float(cfg.algo.unimix)
    m = cfg.algo.actor.moments
    moments_args = (float(m.decay), float(m.max), float(m.percentile.low), float(m.percentile.high))
    dims = [int(d) for d in actions_dim]
    multiplier = float(cfg.algo.intrinsic_reward_multiplier)
    critics_cfg = {str(k): (float(v["weight"]), str(v["reward_type"])) for k, v in cfg.algo.critics_exploration.items()}
    weights_sum = sum(w for w, _ in critics_cfg.values())
    clips = dict(losses.clips)
    clips["ensembles"] = float(cfg.algo.ensembles.clip_gradients)

    def exploration_actor_loss(wm, actor, ensembles, critics, moments, posteriors, recurrents, true_continue, noise):
        metrics, lambdas, new_moments = {}, {}, {}
        with torch.set_grad_enabled(is_continuous):
            traj, imagined_actions = losses.imagination(
                wm, actor, posteriors, recurrents, noise["exploration_prior"], noise["exploration_actions"]
            )
            continues = continue_distribution(wm.continue_logits(traj)).base.mode
            continues = torch.cat([true_continue[None], continues[1:]])
            discount = torch.cumprod(continues * gamma, dim=0) / gamma
            intrinsic = intrinsic_reward(ensembles, traj.detach(), imagined_actions.detach(), multiplier)
            advantage = 0.0
            for k, (weight, reward_type) in critics_cfg.items():
                values = TwoHotEncodingDistribution(critics[k](traj), dims=1).mean
                if reward_type == "intrinsic":
                    reward = intrinsic
                    metrics[f"Rewards/intrinsic_{k}"] = reward.mean()
                else:
                    reward = TwoHotEncodingDistribution(wm.reward_logits(traj), dims=1).mean
                lambda_values = compute_lambda_values(reward[1:], values[1:], continues[1:] * gamma, lmbda)
                new_moments[k], offset, invscale = update_moments(moments[k], lambda_values, *moments_args)
                advantage = advantage + (
                    (lambda_values - offset) / invscale - (values[:-1] - offset) / invscale
                ) * (weight / weights_sum)
                lambdas[k] = lambda_values.detach()
                metrics[f"Values_exploration/predicted_values_{k}"] = values.detach().mean()
                metrics[f"Values_exploration/lambda_values_{k}"] = lambdas[k].mean()
        policies = build_actor_dists(actor(traj.detach()), is_continuous, distribution, init_std, min_std, unimix)
        if is_continuous:
            objective = advantage
        else:
            per_head = [
                p.log_prob(a)[..., None][:-1] for p, a in zip(policies, torch.split(imagined_actions, dims, dim=-1))
            ]
            objective = sum(per_head) * advantage
        entropy = ent_coef * actor_entropy(policies, distribution)
        policy_loss = -torch.mean(discount[:-1] * (objective + entropy[..., None][:-1]))
        aux = {"trajectories": traj.detach(), "discount": discount.detach(), "lambda_values": lambdas,
               "moments": new_moments, "metrics": metrics}
        return policy_loss, aux

    def exploration_actor_loss_backward(wm, actor, ensembles, critics, *args):
        with _no_param_grads(wm, *critics.values()):
            policy_loss, aux = exploration_actor_loss(wm, actor, ensembles, critics, *args)
            policy_loss.backward()
        return policy_loss, aux

    def _ensemble_loss(ensembles, posteriors, recurrents, actions):
        return ensemble_loss(ensembles, posteriors, recurrents, actions, _mse_log_prob)

    return SimpleNamespace(
        world_model_loss=losses.world_model_loss, imagination=losses.imagination,
        actor_loss_backward=losses.actor_loss_backward, critic_loss=losses.critic_loss,
        ensemble_loss=_ensemble_loss, exploration_actor_loss=exploration_actor_loss,
        exploration_actor_loss_backward=exploration_actor_loss_backward, clips=clips,
    )


def _copy_moments(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor]) -> None:
    with torch.no_grad():
        for k, v in src.items():
            dst[k].copy_(v)


def build_train_fn(cfg, actions_dim: Sequence[int], is_continuous: bool) -> TrainProgram:
    """The exploration phase's gradient step as a
    :class:`~sheeprl_tpu_torch.train.burst.TrainProgram` over
    :func:`build_optimizers_and_state`'s state (the six updates of the
    module's docstring); ``data`` and the metrics as DreamerV3's step has
    them, the metrics under the JAX step's names; ``noise`` is
    :func:`draw_noise`'s dict."""
    losses = build_losses(cfg, actions_dim, is_continuous)
    clips = losses.clips

    def body(state: Dict[str, Any], data: Dict[str, torch.Tensor], noise, tau: torch.Tensor):
        wm, ens = state["world_model"], state["ensembles"]
        critics = state["critics_exploration"]
        opt = state["opt"]
        with torch.no_grad():
            targets = list(state["target_critic_task"].parameters())
            sources = list(state["critic_task"].parameters())
            for c in critics.values():
                targets += list(c["target"].parameters())
                sources += list(c["module"].parameters())
            torch._foreach_mul_(targets, 1.0 - tau)
            torch._foreach_add_(targets, torch._foreach_mul(sources, tau))
            torch._foreach_zero_([p.grad for m in trained_modules(state).values() for p in m.parameters()])

        wm_loss, metrics, posteriors, recurrents = losses.world_model_loss(wm, data, noise["posterior"])
        wm_loss.backward()
        grads = {"world_model": _step(wm, opt["world_model"], clips["world_model"])}

        ens_loss = losses.ensemble_loss(ens, posteriors, recurrents, data["actions"])
        ens_loss.backward()
        grads["ensemble"] = _step(ens, opt["ensembles"], clips["ensembles"])

        true_continue = (1.0 - data["dones"]).reshape(-1, 1)
        modules = {k: c["module"] for k, c in critics.items()}
        policy_expl, aux = losses.exploration_actor_loss_backward(
            wm, state["actor_exploration"], ens, modules, state["moments"]["exploration"], posteriors, recurrents,
            true_continue, noise,
        )
        grads["actor_exploration"] = _step(state["actor_exploration"], opt["actor_exploration"], clips["actor"])
        for k, nm in aux["moments"].items():
            _copy_moments(state["moments"]["exploration"][k], nm)
        metrics = dict(metrics)
        metrics.update(aux["metrics"])
        for k, c in critics.items():
            value_loss = losses.critic_loss(c["module"], c["target"], aux["trajectories"], aux["lambda_values"][k],
                                            aux["discount"])
            value_loss.backward()
            _step(c["module"], opt["critics_exploration"][k], clips["critic"])
            metrics[f"Loss/value_loss_exploration_{k}"] = value_loss.detach()

        policy_task, aux_task = losses.actor_loss_backward(
            wm, state["actor_task"], state["critic_task"], state["moments"]["task"], posteriors, recurrents,
            true_continue, noise,
        )
        grads["actor_task"] = _step(state["actor_task"], opt["actor_task"], clips["actor"])
        _copy_moments(state["moments"]["task"], aux_task["moments"])
        value_task = losses.critic_loss(state["critic_task"], state["target_critic_task"], aux_task["trajectories"],
                                        aux_task["lambda_values"], aux_task["discount"])
        value_task.backward()
        grads["critic_task"] = _step(state["critic_task"], opt["critic_task"], clips["critic"])

        metrics["Loss/ensemble_loss"] = ens_loss.detach()
        metrics["Loss/policy_loss_exploration"] = policy_expl.detach()
        metrics["Loss/policy_loss_task"] = policy_task.detach()
        metrics["Loss/value_loss_task"] = value_task.detach()
        metrics.update({f"Grads/{name}": norm for name, norm in grads.items()})
        return metrics

    def noise_for(T: int, B: int, generator: Optional[torch.Generator], device):
        return draw_noise(cfg, actions_dim, T, B, generator, device, is_continuous)

    return build_train_burst(body, noise_for, prepare)


# ---------------------------------------------------------------------------
# the training run
# ---------------------------------------------------------------------------


def agent_state_dict(state: Dict[str, Any]) -> Dict[str, Any]:
    """The checkpoint's ``agent`` tree under the JAX names: each module's
    ``state_dict`` (``critics_exploration.<name>.{module,target}``), each
    optimizer's per-parameter state and the ``Moments`` states."""
    out: Dict[str, Any] = {name: state[name].state_dict() for name in _MODULES}
    out["critics_exploration"] = {
        k: {"module": c["module"].state_dict(), "target": c["target"].state_dict()}
        for k, c in state["critics_exploration"].items()
    }
    opt = state["opt"]
    out["opt"] = {name: {"state": opt[name].state_dict()["state"]} for name in _TRAINED}
    out["opt"]["critics_exploration"] = {
        k: {"state": o.state_dict()["state"]} for k, o in opt["critics_exploration"].items()
    }
    out["moments"] = {
        "task": {k: v.detach().cpu() for k, v in state["moments"]["task"].items()},
        "exploration": {n: {k: v.detach().cpu() for k, v in m.items()} for n, m in state["moments"]["exploration"].items()},
    }
    return out


def _load_moments(dst: Dict[str, torch.Tensor], saved) -> None:
    for k, v in dst.items():
        v.copy_(torch.as_tensor(np.asarray(saved[k])).reshape(()))


def load_agent_state(state: Dict[str, Any], agent: Dict[str, Any]) -> None:
    """Load an :func:`agent_state_dict` tree (numpy leaves, as a checkpoint
    reads back) into ``state`` in place."""
    as_tensors = lambda sd: {k: torch.as_tensor(v) for k, v in sd.items()}  # noqa: E731
    for name in _MODULES:
        state[name].load_state_dict(as_tensors(agent[name]))
    for k, c in state["critics_exploration"].items():
        c["module"].load_state_dict(as_tensors(agent["critics_exploration"][k]["module"]))
        c["target"].load_state_dict(as_tensors(agent["critics_exploration"][k]["target"]))
    for name in _TRAINED:
        load_optimizer_state(state["opt"][name], agent["opt"][name])
    for k, o in state["opt"]["critics_exploration"].items():
        load_optimizer_state(o, agent["opt"]["critics_exploration"][k])
    with torch.no_grad():
        _load_moments(state["moments"]["task"], agent["moments"]["task"])
        for k, m in state["moments"]["exploration"].items():
            _load_moments(m, agent["moments"]["exploration"][k])


@register_algorithm()
def main(fabric, cfg) -> Dict[str, Any]:
    """The exploration run: DreamerV3's loop acting with the exploration
    actor, the six-update step, a checkpoint of every module, and a test
    episode of the task actor. Returns the loop's result."""
    dv3._unsupported(cfg)
    dv3.check_actor_cls(cfg)
    # the exploration phase always acts with the exploration actor
    cfg.algo.player.actor_type = "exploration"
    run = dv3.open_dv3_run(fabric, cfg)
    modules = build_agent(cfg, run.actions_dim, run.is_continuous, run.observation_space.spaces, seed=cfg.seed,
                          device=run.device)
    state = build_optimizers_and_state(cfg, *modules, generator=run.generator)
    resumed = read_resume_checkpoint(fabric, cfg)
    if resumed is not None:
        load_agent_state(state, resumed["agent"])
    wm = state["world_model"]
    players = {name: build_player_fns(wm, state[name], cfg, run.actions_dim, run.is_continuous)
               for name in ("actor_exploration", "actor_task")}
    return dv3.train_loop(
        fabric, cfg, run, state, build_train_fn(cfg, run.actions_dim, run.is_continuous), resumed,
        players=[players["actor_exploration"]],
        checkpoint_state=lambda: {"agent": agent_state_dict(state)},
        publish=lambda: {"agent": {"world_model": wm.state_dict(), "actor_task": state["actor_task"].state_dict()}},
        test_player=players["actor_task"],
        replay_state=resumed.get("rb") if resumed is not None and cfg.buffer.get("checkpoint", False) else None,
    )

"""Plan2Explore on DreamerV1, the exploration phase (counterpart of
``sheeprl_tpu/algos/p2e_dv1/p2e_dv1_exploration.py``): the gradient step
and the training run (:func:`main`, registered as ``p2e_dv1_exploration``).

One gradient step makes four pairs of updates, in the JAX step's order:

1. the world model, DreamerV1's loss; its update;
2. the ensemble: each member regresses the next observation embedding (the
   encoder's output, detached) from ``(posterior_t, recurrent_t,
   action_t)`` under a unit Gaussian (``Independent(Normal(out, 1), 1)``),
   the output's last step dropped; its update (clip
   ``algo.ensembles.clip_gradients``);
3. the exploration actor, on the updated world model and ensemble:
   DreamerV1's imagination with the exploration actor, the reward the
   ensemble's population variance over members of the predicted embedding
   (averaged over its width, times ``intrinsic_reward_multiplier``, no
   gradient), the exploration critic's values, the V1 λ-targets and
   ``-mean(discount · λ)`` by dynamics backpropagation; its update, then
   the exploration critic's against those targets;
4. the task actor and critic: the same losses with the reward head's mean.

The step is graph-safe like DreamerV1's (a burst replays it from one CUDA
graph a step on the card). The run (:func:`main`) is DreamerV2's loop
(``dreamer_v2.train_loop``, the sequential buffer, no pretraining burst and
no target updates) acting with the exploration actor; its checkpoint holds
every module and optimizer state under the JAX names, and its test episode
plays the task actor.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, Optional, Sequence

import torch

from sheeprl_tpu_torch.algos.dreamer_v1 import dreamer_v1 as dv1
from sheeprl_tpu_torch.algos.dreamer_v1.loss import gaussian_independent
from sheeprl_tpu_torch.algos.dreamer_v2 import dreamer_v2 as dv2
from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import _step, adam_for, give_zero_grads
from sheeprl_tpu_torch.algos.p2e_dv1.agent import build_agent, build_player_fns
from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_exploration import intrinsic_reward
from sheeprl_tpu_torch.obs.learn import learn_tap, probe_losses
from sheeprl_tpu_torch.train.burst import TrainProgram, build_train_burst
from sheeprl_tpu_torch.utils.registry import register_algorithm

__all__ = [
    "build_losses",
    "build_optimizers_and_state",
    "build_train_fn",
    "draw_noise",
    "ensemble_loss",
    "main",
]

#: the modules, each with its own optimizer
_MODULES = ("world_model", "ensembles", "actor_exploration", "critic_exploration", "actor_task", "critic_task")


def build_optimizers_and_state(cfg, world_model, actor_task, critic_task, actor_exploration, critic_exploration,
                               ensembles, generator=None) -> Dict[str, Any]:
    """The agent state a step updates: the modules, one ``Adam`` each (the
    ensemble's at ``algo.ensembles.optimizer``, the exploration actor's and
    critic's at the task actor's and critic's settings) and the generator
    noise is drawn from when the step is given none."""
    modules = dict(world_model=world_model, actor_task=actor_task, critic_task=critic_task,
                   actor_exploration=actor_exploration, critic_exploration=critic_exploration, ensembles=ensembles)
    groups = {"world_model": cfg.algo.world_model, "ensembles": cfg.algo.ensembles, "actor_task": cfg.algo.actor,
              "critic_task": cfg.algo.critic, "actor_exploration": cfg.algo.actor,
              "critic_exploration": cfg.algo.critic}
    opt = {name: adam_for(modules[name], group.optimizer) for name, group in groups.items()}
    return {**modules, "opt": opt, "generator": generator}


def _prepare(state: Dict[str, Any]) -> None:
    give_zero_grads(state[name] for name in _MODULES)


def draw_noise(cfg, actions_dim: Sequence[int], T: int, B: int, generator: Optional[torch.Generator], device,
               is_continuous: bool = False) -> Dict[str, Any]:
    """DreamerV1's step noise (``posterior``, and the task actor's
    imagination ``prior`` and ``actions``) and the exploration actor's
    imagination's (``exploration_prior`` ``[horizon, T·B, S]``,
    ``exploration_actions`` ``[horizon, T·B, dim]`` a head)."""
    noise = dv1.draw_noise(cfg, actions_dim, T, B, generator, device, is_continuous)
    noise.update(dv1.draw_noise(cfg, actions_dim, T, B, generator, device, is_continuous, prefix="exploration_"))
    return noise


def ensemble_loss(ensembles, posteriors, recurrents, actions, embedded) -> torch.Tensor:
    """``−Σ_members mean_{t,b} log N(embedded[1:]; out, 1)``: each member
    predicts the next observation embedding from ``[posterior_t,
    recurrent_t, action_t]``, its last step dropped."""
    out = ensembles(torch.cat([posteriors, recurrents, actions], dim=-1))[:, :-1]
    lp = gaussian_independent(out, 1.0, 1).log_prob(embedded[1:][None])
    return -torch.sum(torch.mean(lp, dim=tuple(range(1, out.dim() - 1))))


def build_losses(cfg, actions_dim: Sequence[int], is_continuous: bool) -> SimpleNamespace:
    """DreamerV1's losses (``world_model_loss``, ``behaviour_loss``,
    ``critic_loss``) and :func:`ensemble_loss`, with the clip norms
    (``clips``, the ensemble's under ``ensembles``)."""
    losses = dv1.build_losses(cfg, actions_dim, is_continuous)
    losses.clips = dict(losses.clips, ensembles=float(cfg.algo.ensembles.clip_gradients))
    losses.ensemble_loss = ensemble_loss
    return losses


def build_train_fn(cfg, actions_dim: Sequence[int], is_continuous: bool) -> TrainProgram:
    """The exploration phase's gradient step as a
    :class:`~sheeprl_tpu_torch.train.burst.TrainProgram` over
    :func:`build_optimizers_and_state`'s state (the updates of the module's
    docstring); ``data`` and the metrics as DreamerV1's step has them, the
    metrics under the JAX step's names; ``noise`` is :func:`draw_noise`'s
    dict."""
    losses = build_losses(cfg, actions_dim, is_continuous)
    clips = losses.clips
    multiplier = float(cfg.algo.intrinsic_reward_multiplier)

    def body(state: Dict[str, Any], data: Dict[str, torch.Tensor], noise, tau: torch.Tensor):
        del tau  # no target critics
        wm, ens, opt = state["world_model"], state["ensembles"], state["opt"]
        with torch.no_grad():
            torch._foreach_zero_([p.grad for name in _MODULES for p in state[name].parameters()])

        wm_loss, metrics, posteriors, recurrents, embedded = losses.world_model_loss(wm, data, noise["posterior"])
        wm_loss.backward()
        grads = {"world_model": _step(wm, opt["world_model"], clips["world_model"], "world_model")}

        ens_loss = ensemble_loss(ens, posteriors, recurrents, data["actions"], embedded)
        ens_loss.backward()
        grads["ensemble"] = _step(ens, opt["ensembles"], clips["ensembles"], "ensembles")

        policy_expl, value_expl, aux_expl, grads["actor_exploration"], grads["critic_exploration"] = (
            dv1.behaviour_update(
                losses, wm, state["actor_exploration"], state["critic_exploration"], opt["actor_exploration"],
                opt["critic_exploration"], clips, posteriors, recurrents, noise["exploration_prior"],
                noise["exploration_actions"],
                lambda traj, actions: intrinsic_reward(ens, traj.detach(), actions.detach(), multiplier),
                names=("actor_exploration", "critic_exploration"),
            )
        )
        policy_task, value_task, _aux, grads["actor_task"], grads["critic_task"] = dv1.behaviour_update(
            losses, wm, state["actor_task"], state["critic_task"], opt["actor_task"], opt["critic_task"], clips,
            posteriors, recurrents, noise["prior"], noise["actions"], lambda traj, actions: wm.reward(traj),
            names=("actor_task", "critic_task"),
        )
        probe_losses(wm_loss, ens_loss, policy_expl, value_expl, policy_task, value_task)

        metrics = dict(metrics)
        metrics["Loss/ensemble_loss"] = ens_loss.detach()
        metrics["Loss/policy_loss_exploration"] = policy_expl
        metrics["Loss/value_loss_exploration"] = value_expl
        metrics["Loss/policy_loss_task"] = policy_task
        metrics["Loss/value_loss_task"] = value_task
        metrics["Rewards/intrinsic"] = aux_expl["reward_mean"]
        metrics["Values_exploration/predicted_values"] = aux_expl["values_mean"]
        metrics["Values_exploration/lambda_values"] = aux_expl["lambda_values"].mean()
        metrics.update({f"Grads/{name}": norm for name, norm in grads.items()})
        return metrics

    def noise_for(T: int, B: int, generator: Optional[torch.Generator], device):
        return draw_noise(cfg, actions_dim, T, B, generator, device, is_continuous)

    return build_train_burst(body, noise_for, _prepare, learn_tap())


@register_algorithm()
def main(fabric, cfg) -> Dict[str, Any]:
    """The exploration run: DreamerV2's loop acting with the exploration
    actor, the P2E-DV1 step, a checkpoint of every module, and a test
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
        dv1.load_agent_state(state, resumed["agent"], _MODULES)
    wm = state["world_model"]
    players = {name: build_player_fns(wm, state[name], cfg, run.actions_dim, run.is_continuous)
               for name in ("actor_exploration", "actor_task")}
    return dv2.train_loop(
        fabric, cfg, run, state, build_train_fn(cfg, run.actions_dim, run.is_continuous), resumed,
        players=[players["actor_exploration"]],
        checkpoint_state=lambda: {"agent": dv1.agent_state_dict(state, _MODULES)},
        publish=lambda: {"agent": {"world_model": wm.state_dict(), "actor_task": state["actor_task"].state_dict()}},
        test_player=players["actor_task"],
        buffer_kind="sequential",
        hard_target_updates=False,
        replay_state=resumed.get("rb") if resumed is not None and cfg.buffer.get("checkpoint", False) else None,
    )

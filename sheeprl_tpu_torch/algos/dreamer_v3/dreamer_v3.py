"""DreamerV3 training (counterpart of ``sheeprl_tpu/algos/dreamer_v3/dreamer_v3.py``):
the gradient step (``build_train_fn``, ``build_optimizers_and_state``) and
the training run (:func:`main`, registered as ``dreamer_v3``).

The step keeps the JAX step's order:

1. the target critic ``t ← τ·c + (1−τ)·t`` before any update (``τ`` = 0.02
   every step in the presets, 1 on the run's first step);
2. the world model: the embed half of the posterior trunk over the whole
   ``[T, B]`` batch, the posterior loop over T with ``is_first[0] = 1``, the
   actions shifted one step (row t holds the action taken at observation t;
   the loop feeds the one that led to it) and an ``is_first`` row starting
   from the prior's mode at a zero recurrent state; the prior logits batched
   over ``[T, B]``; the MSE pixel, symlog vector, two-hot reward and
   Bernoulli continue heads; the KL balance with free nats; its update;
3. the actor, on the **updated** world model: a ``horizon``-step imagination
   from every ``(t, b)`` posterior, the first action from the starting
   latent and each next one from the new latent, the critic's and the
   reward head's two-hot means, the continue head's mode, λ-returns, the
   5%/95% return percentiles' EMA (``Moments``) scaling the advantage, and
   the REINFORCE loss (discrete actions) or the scaled advantage itself
   (continuous actions: dynamics backprop) with entropy; its update;
4. the critic, two-hot, against the λ-returns and the target critic's
   values on the same trajectories; its update.

With discrete actions nothing of the actor loss's gradient passes through
the imagination (the JAX loss stops the gradient at the trajectories, the
actions and the advantage), so the imagination runs without autograd; its
15 cell steps launch the kernel all the same. With continuous actions the
objective is the advantage, so the gradient flows from the critic's and the
reward head's values back through every imagined latent, each cell step's
VJP and the reparameterized actions into the actor; the actor sees each
latent detached, as the JAX ``sg(latent)``. JAX differentiates the actor
loss in the actor's parameters alone: here the world model and the critic
take no gradient while the actor's loss is formed and differentiated, so
that their ``.grad`` (and the cell's weight gradient) is never computed.

The JAX package runs the step as one SPMD program; here it is PyTorch on
one device a process, updating the state in place (parameters, the
optimizers' state, the target critic and the ``Moments`` state). In a
data-parallel world (``fabric.devices>1``) each module's gradients are the
world's mean before its clip (``dreamer_v2._step``), ``Moments`` takes its
percentiles over every rank's λ-returns and the metrics are the world's
mean, all through ``obs.dist.comms``; each rank steps its own
``env.num_envs`` envs (JAX's global env indices for their seeds), samples
its own buffer and draws its noise from its own generator. The step is
wrapped as a
:class:`~sheeprl_tpu_torch.train.burst.TrainProgram`: eager when called,
replayed from one CUDA graph a step in a burst on the card. Noise is an
input (``noise``, for parity with the JAX step's keys) or drawn from the
state's ``torch.Generator``.

The run (:func:`main`) keeps the JAX loop's order and bookkeeping: the
sequential buffer, a row stored before each env step with the action taken
at its observation, the real final observation stored as a ``done`` row for
an env that ended and its next row marked ``is_first``, the ended env's
player state reset then (to the prior's mode under the weights of that
moment), random actions up to ``learning_starts``, training every
``train_every`` policy steps (``per_rank_pretrain_steps`` at
``learning_starts``), the target update every
``target_network_update_freq`` gradient steps with the very first one hard,
the polynomial decay of ``expl_amount``, the ``should_checkpoint`` cadence
(``save_last`` on the final update, the buffer with it under
``buffer.checkpoint``), logging at ``metric.log_level=1`` into a
TensorBoard event file, and a test episode at the end that samples its
actions at zero exploration. Each acting step is one replay of
:class:`~sheeprl_tpu_torch.algos.dreamer_v3.agent.ExplorationStep`'s graph
on the card. With ``eval.every_n_steps`` it publishes the acting modules for
in-run evaluation (``evals/inrun.py``). Telemetry, the profiler and burst
acting are not ported and raise; the actor–learner plane serves the
decoupled entrypoints only (``plane.num_players`` warns here, as in JAX).
"""

from __future__ import annotations

import os
import warnings
from types import SimpleNamespace
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import (
    _no_param_grads,
    _prepare,
    _run_result,
    _step,
    acting_order,
    open_run,
    read_resume_checkpoint,
)
from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import _unsupported as _dv2_unsupported
from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import agent_state_dict as _modules_state_dict
from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import build_optimizers_and_state as _build_optimizers
from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import load_agent_state as _load_modules_state
from sheeprl_tpu_torch.algos.dreamer_v3.agent import (
    Actor,
    ExplorationStep,
    actor_entropy,
    actor_noise,
    build_actor_dists,
    build_agent,
    build_player_fns,
    is_minedojo,
    resolve_actor_distribution,
    sample_actor_actions,
)
from sheeprl_tpu_torch.algos.dreamer_v3.loss import continue_distribution, reconstruction_loss
from sheeprl_tpu_torch.algos.dreamer_v3.minedojo_actor import MASK_KEYS, MinedojoActor
from sheeprl_tpu_torch.algos.dreamer_v3.utils import (
    compute_lambda_values,
    init_moments,
    normalize_obs_tensors,
    prepare_obs,
    test,
    update_moments,
)
from sheeprl_tpu_torch.ckpt import preemption_requested, should_checkpoint, warn_checkpoint_rounding
from sheeprl_tpu_torch.config.instantiate import instantiate
from sheeprl_tpu_torch.data.staging import make_replay_staging
from sheeprl_tpu_torch.distributions import (
    MSEDistribution,
    SymlogDistribution,
    TwoHotEncodingDistribution,
    gumbel_noise,
)
from sheeprl_tpu_torch.evals.inrun import maybe_start_inrun_eval
from sheeprl_tpu_torch.obs.dist.comms import pmean
from sheeprl_tpu_torch.obs.learn import learn_tap, probe_losses
from sheeprl_tpu_torch.obs.perf import PhaseSeconds, log_sps_metrics, register_step_cost
from sheeprl_tpu_torch.obs.prof.capture import profile_tick
from sheeprl_tpu_torch.obs.spans import span
from sheeprl_tpu_torch.replay import make_replay_buffer
from sheeprl_tpu_torch.train.burst import (
    TrainProgram,
    build_train_burst,
    metric_fetch_gate,
    run_train_burst,
    tau_schedule,
)
from sheeprl_tpu_torch.utils.metric import MetricAggregator, SumMetric
from sheeprl_tpu_torch.utils.registry import register_algorithm
from sheeprl_tpu_torch.utils.utils import polynomial_decay

__all__ = [
    "agent_state_dict",
    "build_losses",
    "build_optimizers_and_state",
    "build_train_fn",
    "check_actor_cls",
    "draw_noise",
    "load_agent_state",
    "main",
    "open_dv3_run",
    "resolve_actor_cls",
    "train_loop",
]

_MODULES = ("world_model", "actor", "critic")
_PORT_PREFIX, _JAX_PREFIX = "sheeprl_tpu_torch.", "sheeprl_tpu."


def build_optimizers_and_state(cfg, world_model, actor, critic, target_critic, generator=None) -> Dict[str, Any]:
    """The agent state a train step updates: the four modules, one
    ``utils.optim.Adam`` per trained module, the ``Moments`` state
    (``{"low", "high"}`` 0-dim tensors on the modules' device) and the
    generator noise is drawn from when the step is given none."""
    state = _build_optimizers(cfg, world_model, actor, critic, target_critic, generator)
    state["moments"] = init_moments(next(world_model.parameters()).device)
    return state


def draw_noise(cfg, actions_dim: Sequence[int], T: int, B: int, generator: Optional[torch.Generator], device,
               is_continuous: bool = False):
    """The noise of one step: the posterior's Gumbels ``[T, B, S, D]``, the
    imagined priors' ``[horizon, T·B, S, D]`` and each action head's samples'
    ``[horizon + 1, T·B, dim]`` (the starting latent's action, then one a
    step): Gumbels for a categorical head, the continuous actor's base noise
    (``actor_noise``: uniforms for ``trunc_normal``) for its one head of
    width ``Σdims``."""
    wm_cfg = cfg.algo.world_model
    S, D, horizon = int(wm_cfg.stochastic_size), int(wm_cfg.discrete_size), int(cfg.algo.horizon)
    distribution = resolve_actor_distribution(cfg.distribution.get("type", "auto"), is_continuous)
    heads = [int(np.sum(actions_dim))] if is_continuous else [int(d) for d in actions_dim]
    return {
        "posterior": gumbel_noise((T, B, S, D), generator, device=device),
        "prior": gumbel_noise((horizon, T * B, S, D), generator, device=device),
        "actions": [actor_noise(distribution, (horizon + 1, T * B, d), generator, device) for d in heads],
    }


def build_losses(cfg, actions_dim: Sequence[int], is_continuous: bool) -> SimpleNamespace:
    """The step's three losses at ``cfg``'s settings: ``world_model_loss(wm,
    data, posterior_gumbels) -> (loss, metrics, posteriors, recurrents)``,
    ``actor_loss(wm, actor, critic, moments, posteriors, recurrents,
    true_continue, noise) -> (loss, aux)`` (``aux["moments"]`` the updated
    ``Moments`` state) and ``critic_loss(critic, target, trajectories,
    lambda_values, discount)``, with the clip norms (``clips``). The actor
    loss is differentiated in the actor alone (``actor_loss_backward``)."""
    cnn_keys, mlp_keys = list(cfg.cnn_keys.encoder), list(cfg.mlp_keys.encoder)
    cnn_dec_keys, mlp_dec_keys = list(cfg.cnn_keys.decoder), list(cfg.mlp_keys.decoder)
    wm_cfg = cfg.algo.world_model
    S, D = int(wm_cfg.stochastic_size), int(wm_cfg.discrete_size)
    stoch_flat, rec_size = S * D, int(wm_cfg.recurrent_model.recurrent_state_size)
    horizon, gamma, lmbda = int(cfg.algo.horizon), float(cfg.algo.gamma), float(cfg.algo.lmbda)
    kl = dict(
        kl_dynamic=float(wm_cfg.kl_dynamic), kl_representation=float(wm_cfg.kl_representation),
        kl_free_nats=float(wm_cfg.kl_free_nats), kl_regularizer=float(wm_cfg.kl_regularizer),
        continue_scale_factor=float(wm_cfg.continue_scale_factor),
    )
    ent_coef = float(cfg.algo.actor.ent_coef)
    distribution = resolve_actor_distribution(cfg.distribution.get("type", "auto"), is_continuous)
    init_std, min_std = float(cfg.algo.actor.init_std), float(cfg.algo.actor.min_std)
    unimix = float(cfg.algo.unimix)
    m = cfg.algo.actor.moments
    moments_args = (float(m.decay), float(m.max), float(m.percentile.low), float(m.percentile.high))
    dims = [int(d) for d in actions_dim]
    clips = {name: float(cfg.algo[name].clip_gradients) for name in _MODULES}

    def policy(actor, latent):
        return build_actor_dists(actor(latent), is_continuous, distribution, init_std, min_std, unimix)

    def world_model_loss(wm, data, gumbels):
        T, B = data["rewards"].shape[:2]
        batch_obs = normalize_obs_tensors({k: data[k] for k in cnn_keys + mlp_keys}, cnn_keys)
        is_first = data["is_first"].clone()
        is_first[0] = 1.0
        actions = torch.cat([torch.zeros_like(data["actions"][:1]), data["actions"][:-1]])
        embed_proj = wm.rssm.project_embed(wm.encode(batch_obs))
        f32 = dict(dtype=torch.float32, device=embed_proj.device)  # the carried state is f32 at any precision
        init_post = wm.initial_posterior(torch.zeros((1, rec_size), **f32))
        posterior = torch.zeros((B, stoch_flat), **f32)
        recurrent = torch.zeros((B, rec_size), **f32)
        recurrents, posteriors, post_logits = [], [], []
        for t in range(T):
            recurrent, posterior, logits = wm.rssm.dynamic_posterior(
                posterior, recurrent, actions[t], embed_proj[t], is_first[t], init_post, gumbel=gumbels[t]
            )
            recurrents.append(recurrent)
            posteriors.append(posterior)
            post_logits.append(logits)
        recurrents, posteriors = torch.stack(recurrents), torch.stack(posteriors)
        prior_logits = wm.rssm.prior_logits(recurrents)
        latents = torch.cat([posteriors, recurrents], dim=-1)
        recon = wm.decode(latents)
        po = {k: MSEDistribution(recon[k], dims=3) for k in cnn_dec_keys}
        po.update({k: SymlogDistribution(recon[k], dims=1) for k in mlp_dec_keys})
        loss, metrics = reconstruction_loss(
            po, batch_obs, TwoHotEncodingDistribution(wm.reward_logits(latents), dims=1), data["rewards"],
            prior_logits.reshape(T, B, S, D), torch.stack(post_logits).reshape(T, B, S, D),
            pc=continue_distribution(wm.continue_logits(latents)), continue_targets=1.0 - data["dones"], **kl,
        )
        return loss, metrics, posteriors.detach(), recurrents.detach()

    def imagination(wm, actor, posteriors, recurrents, prior_gumbels, action_noise):
        """``(trajectories [H+1, TB, L], actions [H+1, TB, A])``: the action
        of each latent, the starting one's first. Autograd runs through it
        only for continuous actions, the actor seeing each latent detached."""
        prior = posteriors.reshape(-1, stoch_flat)
        recurrent = recurrents.reshape(-1, rec_size)
        latent = torch.cat([prior, recurrent], dim=-1)
        latents, actions = [latent], []
        for i in range(horizon + 1):
            dists = policy(actor, latent.detach())
            action = torch.cat(sample_actor_actions(dists, is_continuous, noise=[n[i] for n in action_noise]), dim=-1)
            actions.append(action)
            if i == horizon:
                break
            prior, recurrent = wm.rssm.imagination(prior, recurrent, action, gumbel=prior_gumbels[i])
            latent = torch.cat([prior, recurrent], dim=-1)
            latents.append(latent)
        return torch.stack(latents), torch.stack(actions)

    def actor_loss(wm, actor, critic, moments, posteriors, recurrents, true_continue, noise):
        with torch.set_grad_enabled(is_continuous):
            traj, imagined_actions = imagination(wm, actor, posteriors, recurrents, noise["prior"], noise["actions"])
            predicted_values = TwoHotEncodingDistribution(critic(traj), dims=1).mean
            predicted_rewards = TwoHotEncodingDistribution(wm.reward_logits(traj), dims=1).mean
            continues = continue_distribution(wm.continue_logits(traj)).base.mode
            continues = torch.cat([true_continue[None], continues[1:]])
            lambda_values = compute_lambda_values(
                predicted_rewards[1:], predicted_values[1:], continues[1:] * gamma, lmbda
            )
            discount = torch.cumprod(continues * gamma, dim=0) / gamma
            new_moments, offset, invscale = update_moments(moments, lambda_values, *moments_args)
            baseline = predicted_values[:-1]
            advantage = (lambda_values - offset) / invscale - (baseline - offset) / invscale
        policies = policy(actor, traj.detach())
        if is_continuous:
            objective = advantage
        else:
            per_head = [
                p.log_prob(a)[..., None][:-1] for p, a in zip(policies, torch.split(imagined_actions, dims, dim=-1))
            ]
            objective = sum(per_head) * advantage
        entropy = ent_coef * actor_entropy(policies, distribution)
        policy_loss = -torch.mean(discount[:-1] * (objective + entropy[..., None][:-1]))
        aux = {
            "trajectories": traj.detach(),
            "lambda_values": lambda_values.detach(),
            "discount": discount,
            "moments": new_moments,
            "User/LambdaValues": lambda_values.detach().mean(),
            "User/Advantages": advantage.detach().mean(),
            "User/Entropy": entropy.detach().mean(),
            "User/PredictedRewards": predicted_rewards.detach().mean(),
            "User/PredictedValues": predicted_values.detach().mean(),
        }
        return policy_loss, aux

    def actor_loss_backward(wm, actor, critic, moments, posteriors, recurrents, true_continue, noise):
        """:func:`actor_loss` and its backward into the actor's ``.grad``
        alone: the world model and the critic take no gradient meanwhile."""
        with _no_param_grads(wm, critic):
            policy_loss, aux = actor_loss(wm, actor, critic, moments, posteriors, recurrents, true_continue, noise)
            policy_loss.backward()
        return policy_loss, aux

    def critic_loss(critic, target, traj, lambda_values, discount):
        qv = TwoHotEncodingDistribution(critic(traj[:-1]), dims=1)
        with torch.no_grad():
            target_values = TwoHotEncodingDistribution(target(traj[:-1]), dims=1).mean
        value_loss = -qv.log_prob(lambda_values) - qv.log_prob(target_values)
        return torch.mean(value_loss * discount[:-1, ..., 0])

    return SimpleNamespace(
        world_model_loss=world_model_loss, imagination=imagination, actor_loss=actor_loss,
        actor_loss_backward=actor_loss_backward, critic_loss=critic_loss, clips=clips,
    )


def build_train_fn(cfg, actions_dim: Sequence[int], is_continuous: bool) -> TrainProgram:
    """The gradient step as a :class:`~sheeprl_tpu_torch.train.burst.TrainProgram`:
    ``program(state, data, noise=None, tau=0.0) -> metrics`` is one eager
    step, ``program.burst(state, data_stack, taus)`` the staged burst, each
    step replayed from one CUDA graph on the card.

    ``state`` comes from :func:`build_optimizers_and_state`; ``data`` holds
    ``[T, B, ...]`` tensors on the modules' device: the observation keys
    (uint8 pixels ``[T, B, C, H, W]``), ``actions`` (one-hot, or the float
    vector of continuous actions: the action taken at each row's
    observation), ``rewards``, ``dones`` and
    ``is_first`` (``[T, B, 1]``). ``noise`` is :func:`draw_noise`'s dict.
    The metrics are 0-dim device tensors under the JAX step's names.

    The step's body has no host branch and no host synchronisation: the
    target update is a lerp by the device scalar ``τ``, the noise is an
    input, the percentiles are device operations, and the gradients, the
    optimizers' state, the target and the ``Moments`` state are updated in
    place."""
    losses = build_losses(cfg, actions_dim, is_continuous)
    world_model_loss, actor_loss_backward, critic_loss = (
        losses.world_model_loss, losses.actor_loss_backward, losses.critic_loss
    )
    clips = losses.clips

    def body(state: Dict[str, Any], data: Dict[str, torch.Tensor], noise, tau: torch.Tensor):
        wm, actor, critic, target = state["world_model"], state["actor"], state["critic"], state["target_critic"]
        opt = state["opt"]
        with torch.no_grad():
            target_params = list(target.parameters())
            torch._foreach_mul_(target_params, 1.0 - tau)
            torch._foreach_add_(target_params, torch._foreach_mul(list(critic.parameters()), tau))
            torch._foreach_zero_([p.grad for name in _MODULES for p in state[name].parameters()])

        wm_loss, metrics, posteriors, recurrents = world_model_loss(wm, data, noise["posterior"])
        wm_loss.backward()
        grad_norms = {"world_model": _step(wm, opt["world_model"], clips["world_model"], "world_model")}

        true_continue = (1.0 - data["dones"]).reshape(-1, 1)
        policy_loss, aux = actor_loss_backward(
            wm, actor, critic, state["moments"], posteriors, recurrents, true_continue, noise
        )
        grad_norms["actor"] = _step(actor, opt["actor"], clips["actor"], "actor")
        with torch.no_grad():
            for k, v in aux.pop("moments").items():
                state["moments"][k].copy_(v)

        value_loss = critic_loss(critic, target, aux.pop("trajectories"), aux.pop("lambda_values"), aux.pop("discount"))
        value_loss.backward()
        grad_norms["critic"] = _step(critic, opt["critic"], clips["critic"], "critic")
        probe_losses(wm_loss, policy_loss, value_loss)

        metrics = dict(metrics)
        metrics["Loss/policy_loss"] = policy_loss.detach()
        metrics.update(aux)
        metrics["Loss/value_loss"] = value_loss.detach()
        metrics.update({f"Grads/{name}": norm for name, norm in grad_norms.items()})
        return pmean(metrics)

    def noise_for(T: int, B: int, generator: Optional[torch.Generator], device):
        return draw_noise(cfg, actions_dim, T, B, generator, device, is_continuous)

    return build_train_burst(body, noise_for, _prepare, learn_tap())


# ---------------------------------------------------------------------------
# the training run
# ---------------------------------------------------------------------------


def agent_state_dict(state: Dict[str, Any]) -> Dict[str, Any]:
    """The checkpoint's ``agent`` tree: each module's ``state_dict``, each
    optimizer's per-parameter state and the ``Moments`` state."""
    out = _modules_state_dict(state)
    out["moments"] = {k: v.detach().cpu() for k, v in state["moments"].items()}
    return out


def load_agent_state(state: Dict[str, Any], agent: Dict[str, Any]) -> None:
    """Load an :func:`agent_state_dict` tree (numpy leaves, as a checkpoint
    reads back) into ``state`` in place."""
    _load_modules_state(state, agent)
    for k, v in state["moments"].items():
        v.copy_(torch.as_tensor(agent["moments"][k]).reshape(()))


def resolve_actor_cls(name: str):
    """``algo.actor.cls`` as a class of the port: a JAX run's
    ``sheeprl_tpu.…`` path names the port's module of the same path; a path
    outside the port, or one the port lacks, raises."""
    import importlib

    name = str(name)
    if name.startswith(_JAX_PREFIX) and not name.startswith(_PORT_PREFIX):
        name = _PORT_PREFIX + name[len(_JAX_PREFIX):]
    if not name.startswith(_PORT_PREFIX):
        raise ValueError(f"algo.actor.cls={name}: the port builds only its own actor classes")
    module, _, attr = name.rpartition(".")
    try:
        return getattr(importlib.import_module(module), attr)
    except (ImportError, AttributeError) as err:
        raise NotImplementedError(f"algo.actor.cls={name}: not in the port") from err


def _unsupported(cfg) -> None:
    """Raise for the options whose layers the port does not have yet."""
    _dv2_unsupported(cfg)


def check_actor_cls(cfg) -> None:
    """The port's DreamerV3 ``Actor`` (discrete, or its continuous form), or
    ``minedojo_actor.MinedojoActor`` on MineDojo's wrapper. As in the JAX
    package, MineDojo's masked sampling follows the wrapper's ``_target_``
    whichever of the two is named."""
    cls = resolve_actor_cls(cfg.algo.actor.cls)
    if cls is MinedojoActor and not is_minedojo(cfg):
        raise ValueError(
            f"algo.actor.cls={cfg.algo.actor.cls}: the MineDojo actor acts on the MineDojo wrapper's masks "
            "(env=minedojo)"
        )
    if cls not in (Actor, MinedojoActor):
        raise NotImplementedError(
            f"algo.actor.cls={cfg.algo.actor.cls}: only the discrete Actor and its continuous form (the port's Actor) "
            "are ported"
        )


def train_loop(
    fabric,
    cfg,
    run: SimpleNamespace,
    state: Dict[str, Any],
    train_program: TrainProgram,
    resumed: Optional[Dict[str, Any]],
    *,
    players: Sequence[Dict[str, Any]],
    checkpoint_state: Callable[[], Dict[str, Any]],
    publish: Callable[[], Dict[str, Any]],
    test_player: Dict[str, Any],
    random_prefill: bool = True,
    switch_at_learning_starts: bool = False,
    expl_decay_steps: Optional[int] = None,
    replay_state: Optional[Dict[str, Any]] = None,
    masked_acting: bool = False,
) -> Dict[str, Any]:
    """The DreamerV3 loop over an agent built by the caller (:func:`main`,
    the P2E entrypoints), with the hooks of
    :func:`~sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2.train_loop`: the
    acting ``players`` (one, or the exploration and task actors' with
    ``switch_at_learning_starts``, each replayed from its own captured acting
    step, the player state carried over at the switch), the checkpoint's
    entries, the in-run publication, the test player, ``random_prefill`` and
    a buffer state to restore. With ``masked_acting`` (MineDojo) the acting
    steps take the env's ``mask_*`` observations beside the observation, as
    inputs of their graph; the test episode takes none, as in JAX."""
    world_size = fabric.world_size
    generator, device, logger, log_dir, envs = run.generator, run.device, run.logger, run.log_dir, run.envs
    n_envs, actions_dim, is_continuous = run.n_envs, run.actions_dim, run.is_continuous
    cnn_keys, mlp_keys, obs_keys = run.cnn_keys, run.mlp_keys, run.obs_keys
    clip_rewards_fn = (lambda r: np.tanh(r)) if cfg.env.clip_rewards else (lambda r: r)
    if expl_decay_steps is None:
        expl_decay_steps = int(resumed["expl_decay_steps"]) if resumed is not None else 0

    aggregator = None
    if not MetricAggregator.disabled:
        aggregator = instantiate(cfg.metric.aggregator)

    rb = make_replay_buffer(
        cfg, fabric, log_dir, n_envs=n_envs, kind="sequential", obs_keys=obs_keys, min_size=4, dry_run_size=4
    )
    if replay_state is not None:
        rb.load_state_dict(replay_state)

    train_step = 0
    last_train = 0
    start_step = int(resumed["update"]) // world_size if resumed is not None else 1
    policy_step = int(resumed["update"]) * cfg.env.num_envs if resumed is not None else 0
    last_log = int(resumed["last_log"]) if resumed is not None else 0
    last_checkpoint = int(resumed["last_checkpoint"]) if resumed is not None else 0
    # every rank steps its n_envs envs: an update is n_envs · world_size policy steps, as JAX counts them
    policy_steps_per_update = int(n_envs) * world_size
    updates_before_training = cfg.algo.train_every // policy_steps_per_update if not cfg.dry_run else 0
    num_updates = int(cfg.total_steps // policy_steps_per_update) if not cfg.dry_run else 1
    learning_starts = cfg.algo.learning_starts // policy_steps_per_update if not cfg.dry_run else 0
    if cfg.checkpoint.resume_from and not cfg.buffer.checkpoint:
        learning_starts += start_step
    max_step_expl_decay = (
        cfg.algo.actor.max_step_expl_decay // (cfg.algo.per_rank_gradient_steps * world_size)
        if cfg.algo.actor.max_step_expl_decay
        else 0
    )
    expl_amount = float(cfg.algo.actor.expl_amount)
    if cfg.checkpoint.resume_from:
        expl_amount = polynomial_decay(
            expl_decay_steps,
            initial=cfg.algo.actor.expl_amount,
            final=cfg.algo.actor.expl_min,
            max_decay_steps=max_step_expl_decay,
        )
    if cfg.metric.log_level > 0 and cfg.metric.log_every % policy_steps_per_update != 0:
        warnings.warn(
            f"The metric.log_every parameter ({cfg.metric.log_every}) is not a multiple of the "
            f"policy_steps_per_update value ({policy_steps_per_update}), so "
            "the metrics will be logged at the nearest greater multiple of the "
            "policy_steps_per_update value."
        )
    warn_checkpoint_rounding(cfg, policy_steps_per_update)
    actor_for = acting_order(players, switch_at_learning_starts, learning_starts)

    staging = make_replay_staging(cfg, fabric, rb, seed=fabric.rank_seed(cfg.seed))

    # env i of rank r is JAX's env r·n_envs + i: its seed is the run's seed plus that index
    o = envs.reset(seed=cfg.seed + fabric.global_rank * n_envs)[0]
    obs = prepare_obs(o, cnn_keys, mlp_keys, n_envs)
    # MineDojo's validity masks, carried beside the observation for the acting steps only
    mask_keys = MASK_KEYS if masked_acting else ()
    masks = {k: np.asarray(o[k]) for k in mask_keys}
    act_width = int(np.sum(actions_dim))
    step_data = {k: obs[k][None] for k in obs_keys}
    step_data["dones"] = np.zeros((1, n_envs, 1), np.float32)
    step_data["rewards"] = np.zeros((1, n_envs, 1), np.float32)
    step_data["is_first"] = np.ones((1, n_envs, 1), np.float32)
    # the acting steps: the player state lives in their static buffers; an env that ends has its row
    # reset right after its env step (the fresh state depends on the weights of that moment)
    actings = [
        ExplorationStep(player_fns, n_envs, {k: obs[k] for k in obs_keys}, cnn_keys, generator, device,
                        reset_in_step=False, masks_example=masks)
        for player_fns in players
    ]
    acting_index = actor_for(start_step)

    seconds = PhaseSeconds("env", "act", "sample", "train", "checkpoint", "test")
    counters = {"updates": 0, "player_steps": 0, "random_steps": 0, "gradient_steps": 0, "train_bursts": 0}
    player_steps_by_actor = [0] * len(players)
    switched_at = None
    checkpoint_path = None

    def env_step(actions: np.ndarray, real_actions: np.ndarray) -> Dict[str, np.ndarray]:
        """Store the row of the current observation with the action taken
        there, step the envs, store a ``done`` row with the real final
        observation of each env that ended and reset its player state;
        returns the player's next observation."""
        nonlocal policy_step
        policy_step += n_envs * world_size
        step_data["actions"] = actions.reshape(1, n_envs, -1).astype(np.float32)
        rb.add(step_data)
        with span("Time/env_interaction_time", SumMetric(), phase="env"):
            o, rewards, terminated, truncated, infos = envs.step(real_actions.reshape(envs.action_space.shape))
        dones = np.logical_or(terminated, truncated).astype(np.float32)
        step_data["is_first"] = np.zeros_like(step_data["dones"])
        if "restart_on_exception" in infos:
            for i, env_roe in enumerate(infos["restart_on_exception"]):
                if env_roe and not dones[i]:
                    staging.force_done_last(i)
                    step_data["is_first"][0, i] = 1.0

        if cfg.metric.log_level > 0 and "final_info" in infos:
            fi = infos["final_info"]
            if isinstance(fi, dict) and "episode" in fi:
                for i in np.nonzero(np.asarray(fi.get("_episode", []), dtype=bool))[0]:
                    ep_rew, ep_len = float(fi["episode"]["r"][i]), float(fi["episode"]["l"][i])
                    if aggregator and "Rewards/rew_avg" in aggregator:
                        aggregator.update("Rewards/rew_avg", ep_rew)
                    if aggregator and "Game/ep_len_avg" in aggregator:
                        aggregator.update("Game/ep_len_avg", ep_len)
                    fabric.print(f"Rank-0: policy_step={policy_step}, reward_env_{i}={ep_rew}")

        dones_idxes = np.nonzero(dones.reshape(-1))[0].tolist()
        real_next_obs = {k: np.array(v) for k, v in o.items()}
        if "final_obs" in infos:
            for idx in dones_idxes:
                fo = infos["final_obs"][idx]
                if fo is not None:
                    for k in real_next_obs:
                        if k in fo:
                            real_next_obs[k][idx] = np.asarray(fo[k])

        new_obs = prepare_obs(o, cnn_keys, mlp_keys, n_envs)
        masks.update({k: np.asarray(o[k]) for k in mask_keys})
        for k in obs_keys:
            step_data[k] = new_obs[k][None]
        step_data["dones"] = dones.reshape(1, n_envs, 1)
        step_data["rewards"] = clip_rewards_fn(np.asarray(rewards, np.float32).reshape(n_envs, 1))[None]

        if dones_idxes:
            reset_obs = prepare_obs(
                {k: v[dones_idxes] for k, v in real_next_obs.items()}, cnn_keys, mlp_keys, len(dones_idxes)
            )
            reset_data = {k: reset_obs[k][None] for k in obs_keys}
            reset_data["dones"] = np.ones((1, len(dones_idxes), 1), np.float32)
            reset_data["actions"] = np.zeros((1, len(dones_idxes), act_width), np.float32)
            reset_data["rewards"] = step_data["rewards"][:, dones_idxes]
            reset_data["is_first"] = np.zeros_like(reset_data["dones"])
            rb.add(reset_data, dones_idxes)
            step_data["rewards"][:, dones_idxes] = 0.0
            step_data["dones"][:, dones_idxes] = 0.0
            step_data["is_first"][:, dones_idxes] = 1.0
            reset_mask = np.zeros((n_envs, 1), np.float32)
            reset_mask[dones_idxes] = 1.0
            actings[acting_index].reset(reset_mask)
        return new_obs

    # in-run eval: the acting modules are published every eval.every_n_steps and scored by a separate
    # process on the CPU, so nothing below waits for an eval episode
    inrun = maybe_start_inrun_eval(fabric, cfg, log_dir)

    update = start_step
    while update <= num_updates:
        if random_prefill and update <= learning_starts and not cfg.checkpoint.resume_from:
            real_actions = actions = np.array(envs.action_space.sample())
            if not is_continuous:
                heads = actions.reshape(n_envs, len(actions_dim))
                actions = np.concatenate(
                    [np.eye(d, dtype=np.float32)[heads[:, j]] for j, d in enumerate(actions_dim)], axis=-1
                )
            counters["random_steps"] += 1
            with seconds.phase("env"):
                obs = env_step(actions, real_actions)
        else:
            with span("Time/rollout_time", SumMetric(), phase="rollout"):
                with seconds.phase("act"):
                    index = actor_for(update)
                    if index != acting_index:
                        # the switch: the next actor's step carries on from the player state as it stands
                        for k, v in actings[acting_index].state.items():
                            actings[index].state[k].copy_(v)
                        acting_index, switched_at = index, update
                    actions_t = actings[index]({k: obs[k] for k in obs_keys}, None, expl_amount, masks=masks)
                    actions = np.concatenate([a.cpu().numpy() for a in actions_t], -1)
                    if is_continuous:
                        real_actions = actions
                    else:
                        real_actions = np.stack([a.argmax(dim=-1).cpu().numpy() for a in actions_t], axis=-1)
                counters["player_steps"] += 1
                player_steps_by_actor[index] += 1
                with seconds.phase("env"):
                    obs = env_step(actions, real_actions)

        update += 1
        last = update - 1
        counters["updates"] += 1
        updates_before_training -= 1

        # Train the agent
        if last >= learning_starts and updates_before_training <= 0:
            n_samples = cfg.algo.per_rank_pretrain_steps if last == learning_starts else cfg.algo.per_rank_gradient_steps
            metrics = None
            if n_samples > 0:
                with seconds.phase("sample"):
                    local_data = staging.sample_device(
                        cfg.per_rank_batch_size,
                        sequence_length=cfg.per_rank_sequence_length,
                        n_samples=n_samples,
                    )
                # EMA targets: soft tau on the cadence, the run's very first gradient step hard-copies
                taus = tau_schedule(
                    n_samples, counters["gradient_steps"], cfg.algo.critic.target_network_update_freq,
                    tau=float(cfg.algo.critic.tau), first_hard=True,
                )
                fetch_metrics = metric_fetch_gate(
                    cfg,
                    aggregator,
                    policy_step=policy_step,
                    last_log=last_log,
                    train_step=train_step,
                    update=last,
                    num_updates=num_updates,
                    policy_steps_per_update=policy_steps_per_update,
                    world_size=world_size,
                )
                with seconds.phase("train"), span(
                    "Time/train_time", SumMetric(sync_on_compute=cfg.metric.sync_on_compute), phase="train"
                ):
                    metrics = run_train_burst(train_program, state, local_data, taus, fetch_metrics=fetch_metrics)
                register_step_cost(train_program.step, dispatches_per_step=cfg.algo.per_rank_gradient_steps,
                                   world_size=world_size)
                counters["gradient_steps"] += n_samples
                counters["train_bursts"] += 1
                train_step += world_size
            updates_before_training = cfg.algo.train_every // policy_steps_per_update
            if cfg.algo.actor.expl_decay:
                expl_decay_steps += 1
                expl_amount = polynomial_decay(
                    expl_decay_steps,
                    initial=cfg.algo.actor.expl_amount,
                    final=cfg.algo.actor.expl_min,
                    max_decay_steps=max_step_expl_decay,
                )
            if aggregator and not aggregator.disabled:
                if metrics is not None:
                    for k, v in metrics.items():
                        if k in aggregator:
                            aggregator.update(k, v)
                if "Params/exploration_amount" in aggregator:
                    aggregator.update("Params/exploration_amount", expl_amount)

        if inrun is not None and last >= learning_starts and inrun.due(policy_step):
            # after the burst: run_train_burst has waited for its stream, so the copy reads settled weights
            inrun.maybe_publish(policy_step, publish())

        # Log metrics
        if cfg.metric.log_level > 0 and (policy_step - last_log >= cfg.metric.log_every or last == num_updates):
            if aggregator and not aggregator.disabled:
                aggregator.sync(fabric)  # every rank's episodes, as the JAX run's one process saw them
                if logger is not None:
                    logger.log_metrics(aggregator.compute(), policy_step)
                aggregator.reset()
            log_sps_metrics(
                logger,
                policy_step=policy_step,
                last_log=last_log,
                train_step=train_step,
                last_train=last_train,
                world_size=world_size,
                action_repeat=cfg.env.action_repeat,
            )
            profile_tick(policy_step=policy_step, world_size=world_size)
            last_log = policy_step
            last_train = train_step

        # Checkpoint
        if should_checkpoint(cfg, policy_step, last_checkpoint, last, num_updates):
            with seconds.phase("checkpoint"), span("Time/checkpoint_time", phase="checkpoint"):
                last_checkpoint = policy_step
                ckpt_state = {
                    **checkpoint_state(),
                    "expl_decay_steps": expl_decay_steps,
                    "update": last * world_size,
                    "batch_size": cfg.per_rank_batch_size * world_size,
                    "last_log": last_log,
                    "last_checkpoint": last_checkpoint,
                }
                checkpoint_path = os.path.join(log_dir, "checkpoint", f"ckpt_{policy_step}_{fabric.global_rank}")
                fabric.call(
                    "on_checkpoint_coupled",
                    ckpt_path=checkpoint_path,
                    state=ckpt_state,
                    replay_buffer=rb if cfg.buffer.get("checkpoint", False) else None,
                )
            if preemption_requested():
                break

    if inrun is not None:
        inrun.close()
    staging.close()
    envs.close()
    test_reward, test_steps = None, 0
    if fabric.is_global_zero and cfg.algo.get("run_test", True) and not preemption_requested():
        with seconds.phase("test"):
            test_reward, test_steps = test(test_player, fabric, cfg, log_dir, sample_actions=True)
    if logger is not None:
        logger.close()
    return _run_result(
        counters, policy_step, inrun, test_steps, test_reward, log_dir, logger, checkpoint_path, seconds, staging,
        train_program, actings, player_steps_by_actor, switched_at,
    )


def open_dv3_run(fabric, cfg) -> SimpleNamespace:
    """:func:`~sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2.open_run` with
    DreamerV3's fixed env settings: no frame stack, a power-of-2 screen."""
    # These arguments cannot be changed
    cfg.env.frame_stack = -1
    if 2 ** int(np.log2(cfg.env.screen_size)) != cfg.env.screen_size:
        raise ValueError(f"The screen size must be a power of 2, got: {cfg.env.screen_size}")
    return open_run(fabric, cfg)


@register_algorithm()
def main(fabric, cfg) -> Dict[str, Any]:
    """The DreamerV3 training run (:func:`train_loop`). Returns its loop
    counters, where its host time went (seconds per phase; the train phase
    ends synchronised with the device) and how its steps ran on the card
    (eager warm-up calls and graph replays)."""
    _unsupported(cfg)
    check_actor_cls(cfg)
    run = open_dv3_run(fabric, cfg)
    modules = build_agent(
        cfg, run.actions_dim, run.is_continuous, run.observation_space.spaces, seed=cfg.seed, device=run.device,
        training=True,
    )
    state = build_optimizers_and_state(cfg, *modules, generator=run.generator)
    resumed = read_resume_checkpoint(fabric, cfg)
    if resumed is not None:
        load_agent_state(state, resumed["agent"])
    fabric.sync_modules(*modules)  # rank 0's starting weights on every rank (a no-op outside a world)
    player_fns = build_player_fns(state["world_model"], state["actor"], cfg, run.actions_dim, run.is_continuous)
    return train_loop(
        fabric, cfg, run, state, build_train_fn(cfg, run.actions_dim, run.is_continuous), resumed,
        players=[player_fns],
        checkpoint_state=lambda: {"agent": agent_state_dict(state)},
        publish=lambda: {"agent": {k: state[k].state_dict() for k in ("world_model", "actor")}},
        test_player=player_fns,
        replay_state=resumed.get("rb") if resumed is not None and cfg.buffer.get("checkpoint", False) else None,
        masked_acting=is_minedojo(cfg),
    )

"""DreamerV2 training (counterpart of ``sheeprl_tpu/algos/dreamer_v2/dreamer_v2.py``):
the gradient step (``build_train_fn``, ``build_optimizers_and_state``) and
the training run (:func:`main`, registered as ``dreamer_v2``).

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

The JAX package runs the step as one SPMD program; here it is PyTorch on
one device a process, updating the state in place (in a data-parallel
world each module's gradients, then the metrics, are the world's mean
through ``obs.dist.comms``: :func:`_step`), wrapped as a
:class:`~sheeprl_tpu_torch.train.burst.TrainProgram`: eager when called,
replayed from one CUDA graph a step in a burst on the card. Sampling noise
is passed in (``noise``, for parity with the JAX step's keys) or drawn from
the state's ``torch.Generator``.

The run (:func:`main`) keeps the JAX loop's order and bookkeeping: a
zero-action ``is_first`` row after the first reset, the real next
observation (``final_obs``) stored for an env that ended, a reset row for
it and ``(1 - mask)`` on its player state, random actions up to
``learning_starts``, training every ``train_every`` policy steps
(``per_rank_pretrain_steps`` at ``learning_starts``), hard target copies
every ``target_network_update_freq`` gradient steps, the polynomial decay
of ``expl_amount``, the ``should_checkpoint`` cadence (``save_last`` on the
final update) and a greedy test episode at the end; the sequential or the
episode buffer (``buffer.type``). At ``metric.log_level=1`` it logs as the
JAX loop does, into a TensorBoard event file of the run directory: the
episodes' ``Rewards/rew_avg`` and ``Game/ep_len_avg``, the train metrics
(pulled from the device at most once a burst, behind ``metric_fetch_gate``),
``Params/exploration_amount`` and the rates of ``log_sps_metrics`` at every
log boundary, and ``Test/cumulative_reward``. It acts one env step at a
time, each acting step one replay of :class:`ExplorationStep`'s graph on
the card. With ``eval.every_n_steps`` it publishes the acting modules for
in-run evaluation (``evals/inrun.py``); telemetry is not ported (ROADMAP
queue A item 6h).
"""

from __future__ import annotations

import contextlib
import os
import warnings
from types import SimpleNamespace
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_v2.agent import (
    ExplorationStep,
    actor_entropy,
    actor_noise,
    build_actor_dists,
    build_agent,
    build_player_fns,
    resolve_actor_distribution,
    sample_actor_actions,
)
from sheeprl_tpu_torch.algos.dreamer_v2.loss import reconstruction_loss
from sheeprl_tpu_torch.algos.dreamer_v2.utils import compute_lambda_values, normalize_obs, normalize_obs_tensors
from sheeprl_tpu_torch.algos.dreamer_v3.utils import prepare_obs, test
from sheeprl_tpu_torch.ckpt import preemption_requested, should_checkpoint, warn_checkpoint_rounding
from sheeprl_tpu_torch.config.instantiate import instantiate
from sheeprl_tpu_torch.data.buffers import EpisodeBuffer
from sheeprl_tpu_torch.data.staging import make_replay_staging
from sheeprl_tpu_torch.distributions import Bernoulli, Independent, Normal, gumbel_noise
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.vector import make_vector_env
from sheeprl_tpu_torch.evals.inrun import maybe_start_inrun_eval
from sheeprl_tpu_torch.obs.dist.comms import pmean, pmean_
from sheeprl_tpu_torch.obs.learn import learn_tap, probe_losses, probe_update
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
from sheeprl_tpu_torch.utils.logger import create_tensorboard_logger
from sheeprl_tpu_torch.utils.metric import MetricAggregator, SumMetric
from sheeprl_tpu_torch.utils.optim import Adam, clip_by_global_norm_
from sheeprl_tpu_torch.utils.registry import register_algorithm
from sheeprl_tpu_torch.utils.utils import polynomial_decay, save_configs

__all__ = [
    "adam_for",
    "agent_state_dict",
    "build_losses",
    "build_optimizers_and_state",
    "build_train_fn",
    "draw_noise",
    "give_zero_grads",
    "load_agent_state",
    "load_optimizer_state",
    "main",
    "open_run",
    "read_resume_checkpoint",
    "train_loop",
]

_MODULES = ("world_model", "actor", "critic")


def build_optimizers_and_state(cfg, world_model, actor, critic, target_critic, generator=None) -> Dict[str, Any]:
    """The agent state a train step updates: the four modules, one optimizer
    per trained module (``utils.optim.Adam``: AdamW with the configured
    decoupled decay) and the generator noise is drawn from when the step is
    given none."""
    modules = {"world_model": world_model, "actor": actor, "critic": critic}
    opt = {name: adam_for(module, cfg.algo[name].optimizer) for name, module in modules.items()}
    return {**modules, "target_critic": target_critic, "opt": opt, "generator": generator}


def adam_for(module: torch.nn.Module, o) -> Adam:
    """The port's ``Adam`` over ``module`` at an ``optimizer`` config node."""
    return Adam(module.parameters(), lr=float(o.lr), betas=tuple(o.betas), eps=float(o.eps),
                weight_decay=float(o.weight_decay))


def draw_noise(cfg, actions_dim: Sequence[int], T: int, B: int, generator: Optional[torch.Generator], device,
               is_continuous: bool = False):
    """The noise of one step: the posterior's Gumbels ``[T, B, S, D]``, the
    imagined priors' ``[horizon, T·B, S, D]`` and each action head's samples'
    ``[horizon, T·B, dim]``: Gumbels for a categorical head, the continuous
    actor's base noise (``actor_noise``) for its one head of width
    ``Σdims``."""
    wm_cfg = cfg.algo.world_model
    S, D, horizon = int(wm_cfg.stochastic_size), int(wm_cfg.discrete_size), int(cfg.algo.horizon)
    distribution = resolve_actor_distribution(cfg.distribution.get("type", "auto"), is_continuous)
    heads = [int(np.sum(actions_dim))] if is_continuous else [int(d) for d in actions_dim]
    return {
        "posterior": gumbel_noise((T, B, S, D), generator, device=device),
        "prior": gumbel_noise((horizon, T * B, S, D), generator, device=device),
        "actions": [actor_noise(distribution, (horizon, T * B, d), generator, device) for d in heads],
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


def _prepare(state: Dict[str, Any]) -> None:
    """:func:`give_zero_grads` to the trained modules."""
    give_zero_grads(state[name] for name in _MODULES)


def give_zero_grads(modules) -> None:
    """Give every parameter of ``modules`` a gradient once (zeros): a step
    zeroes and fills the gradients in place, so their addresses never change
    (a captured step keeps reading them), and a parameter the loss did not
    reach keeps a zero gradient, as in JAX, so the optimizer still decays
    it."""
    for module in modules:
        for p in module.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)


def _step(module: torch.nn.Module, optimizer: torch.optim.Optimizer, clip: float,
          name: Optional[str] = None) -> torch.Tensor:
    """Mean the module's gradients over the data-parallel world (one bucket:
    ``obs.dist.comms.pmean_``, the identity outside a world), clip them
    (optax's global-norm form) and step. Returns the gradient norm before
    clipping. Inside a step built with the learn probes on, the synced
    gradients, the parameters and the applied update are probed under
    ``name`` (``obs/learn``), and the clip reuses the probes' gradient
    norm."""
    params = list(module.parameters())
    grads = [p.grad for p in params]
    pmean_(grads)
    probed = probe_update(name, grads, params, optimizer, clip)
    norm = clip_by_global_norm_(grads, clip, norm=probed.grad_norm)
    optimizer.step()
    probed()
    return norm


def build_losses(cfg, actions_dim: Sequence[int], is_continuous: bool) -> SimpleNamespace:
    """The step's three losses at ``cfg``'s settings: ``world_model_loss(wm,
    data, posterior_gumbels) -> (loss, metrics, posteriors, recurrents)``,
    ``actor_loss(wm, actor, target_critic, posteriors, recurrents,
    true_continue, noise) -> (loss, aux)`` and ``critic_loss(critic,
    trajectories, lambda_values, discount)``, with the clip norms
    (``clips``) and the actor loss's ``imagination(wm, actor, posteriors,
    recurrents, prior_gumbels, action_noise)``."""
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

    def imagination(wm, actor, posteriors, recurrents, prior_gumbels, action_noise):
        """``(trajectories [H+1, TB, L], actions [H+1, TB, A])`` with
        ``actions[0] = 0``; the action is computed inside the loop."""
        prior = posteriors.reshape(-1, stoch_flat)
        recurrent = recurrents.reshape(-1, rec_size)
        latent = latent0 = torch.cat([prior, recurrent], dim=-1)
        latents, actions = [], []
        for i in range(horizon):
            dists = build_actor_dists(actor(latent.detach()), is_continuous, distribution, init_std, min_std, 0.0)
            action = torch.cat(
                sample_actor_actions(dists, is_continuous, is_training=True, noise=[n[i] for n in action_noise]),
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
        entropy = ent_coef * actor_entropy(policies, distribution)
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

    return SimpleNamespace(
        world_model_loss=world_model_loss, imagination=imagination, actor_loss=actor_loss, critic_loss=critic_loss,
        clips=clips,
    )


def build_train_fn(cfg, actions_dim: Sequence[int], is_continuous: bool) -> TrainProgram:
    """The gradient step as a :class:`~sheeprl_tpu_torch.train.burst.TrainProgram`:
    ``program(state, data, noise=None, tau=0.0) -> metrics`` is one eager
    step, ``program.burst(state, data_stack, taus)`` the staged burst, each
    step replayed from one CUDA graph on the card.

    ``state`` comes from :func:`build_optimizers_and_state`; ``data`` holds
    ``[T, B, ...]`` tensors on the modules' device: the observation keys
    (uint8 pixels ``[T, B, C, H, W]``), ``actions`` (one-hot), ``rewards``,
    ``dones`` and ``is_first`` (``[T, B, 1]``). ``noise`` is
    :func:`draw_noise`'s dict. The metrics are 0-dim device tensors under the
    JAX step's names.

    The step's body has no host branch and no host synchronisation: the
    target update is the lerp ``t ← τ·c + (1−τ)·t`` with ``τ`` a device
    scalar, applied at every step (at ``τ`` ∈ {0, 1} it is the JAX step's
    choice between keeping the target and copying the critic, for finite
    values), the noise is an input, and the gradients and optimizer state
    are updated in place."""
    losses = build_losses(cfg, actions_dim, is_continuous)
    world_model_loss, actor_loss, critic_loss = losses.world_model_loss, losses.actor_loss, losses.critic_loss
    clips = losses.clips

    def body(state: Dict[str, Any], data: Dict[str, torch.Tensor], noise, tau: torch.Tensor):
        wm, actor, critic, target = state["world_model"], state["actor"], state["critic"], state["target_critic"]
        opt = state["opt"]
        with torch.no_grad():  # the target chosen by tau before any update
            target_params = list(target.parameters())
            torch._foreach_mul_(target_params, 1.0 - tau)
            torch._foreach_add_(target_params, torch._foreach_mul(list(critic.parameters()), tau))
            torch._foreach_zero_([p.grad for name in _MODULES for p in state[name].parameters()])

        wm_loss, metrics, posteriors, recurrents = world_model_loss(wm, data, noise["posterior"])
        wm_loss.backward()
        grad_norms = {"world_model": _step(wm, opt["world_model"], clips["world_model"], "world_model")}

        true_continue = (1.0 - data["dones"]).reshape(-1, 1)
        with _no_param_grads(wm, target):
            policy_loss, aux = actor_loss(wm, actor, target, posteriors, recurrents, true_continue, noise)
            policy_loss.backward()
        grad_norms["actor"] = _step(actor, opt["actor"], clips["actor"], "actor")

        value_loss = critic_loss(critic, aux["trajectories"], aux["lambda_values"], aux["discount"])
        value_loss.backward()
        grad_norms["critic"] = _step(critic, opt["critic"], clips["critic"], "critic")
        probe_losses(wm_loss, policy_loss, value_loss)

        metrics = dict(metrics)
        metrics["Loss/policy_loss"] = policy_loss.detach()
        metrics["User/PredictedRewards"] = aux["User/PredictedRewards"]
        metrics["User/LambdaValues"] = aux["User/LambdaValues"]
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
    """The checkpoint's ``agent`` tree: each module's ``state_dict`` and each
    optimizer's per-parameter state (its hyperparameters come from the
    config on load)."""
    out: Dict[str, Any] = {name: state[name].state_dict() for name in _MODULES + ("target_critic",)}
    out["opt"] = {name: {"state": opt.state_dict()["state"]} for name, opt in state["opt"].items()}
    return out


def load_agent_state(state: Dict[str, Any], agent: Dict[str, Any]) -> None:
    """Load an :func:`agent_state_dict` tree (numpy leaves, as a checkpoint
    reads back) into ``state`` in place."""
    for name in _MODULES + ("target_critic",):
        state[name].load_state_dict({k: torch.as_tensor(v) for k, v in agent[name].items()})
    for name, opt in state["opt"].items():
        load_optimizer_state(opt, agent["opt"][name])


def load_optimizer_state(opt: torch.optim.Optimizer, saved: Dict[str, Any]) -> None:
    """Load a checkpoint's ``{"state": {index: {...}}}`` (numpy leaves) into
    ``opt`` in place; its hyperparameters stay the config's."""
    per_index = {
        int(i): {k: torch.as_tensor(v) for k, v in per_param.items()} for i, per_param in saved["state"].items()
    }
    opt.load_state_dict({"state": per_index, "param_groups": opt.state_dict()["param_groups"]})


def _graph_counts(steps) -> Dict[str, Any]:
    """How captured steps ran: eager calls, replays, graphs captured, the
    host seconds the eager warm-up calls and the captures took, and the
    world's backend that kept a train step eager on the card (``gloo``, or
    None)."""
    return {
        "eager_backend": next((s.eager_backend for s in steps if s.eager_backend is not None), None),
        "eager_calls": sum(s.eager_calls for s in steps),
        "replays": sum(s.replays for s in steps),
        "captured": sum(s.graph is not None for s in steps),
        "warmup_s": sum(s.warmup_s for s in steps),
        "capture_s": sum(s.capture_s for s in steps),
    }


def _unsupported(cfg) -> None:
    """Raise for the options whose layers the port does not have yet."""
    if int(cfg.env.get("act_burst", 1) or 1) != 1:
        raise NotImplementedError(
            "env.act_burst>1: burst acting amortises TPU dispatches; the port replays each acting step from a CUDA graph"
        )


def open_run(fabric, cfg) -> SimpleNamespace:
    """What every Dreamer run opens before its agent: the seeded generator,
    the logger and the saved config, the vector env and its spaces, and the
    encoder and decoder keys checked against each other (the JAX loops'
    preamble). The caller fixes ``cfg.env``'s frame and screen settings
    first."""
    generator, _ = fabric.seed_everything(cfg.seed)
    logger, log_dir = create_tensorboard_logger(cfg)
    fabric.logger = logger
    if logger is not None:
        logger.log_hyperparams(cfg.as_dict() if hasattr(cfg, "as_dict") else dict(cfg))
    if fabric.is_global_zero:
        save_configs(cfg, log_dir)

    n_envs = int(cfg.env.num_envs)  # this rank's envs
    envs = make_vector_env(cfg, fabric, log_dir, restart_on_exception=True)
    action_space = envs.single_action_space
    observation_space = envs.single_observation_space
    is_continuous = isinstance(action_space, spaces.Box)
    is_multidiscrete = isinstance(action_space, spaces.MultiDiscrete)
    actions_dim = tuple(
        action_space.shape if is_continuous else (action_space.nvec.tolist() if is_multidiscrete else [action_space.n])
    )
    if not isinstance(observation_space, spaces.Dict):
        raise RuntimeError(f"Unexpected observation type, should be of type Dict, got: {observation_space}")
    if cfg.cnn_keys.encoder == [] and cfg.mlp_keys.encoder == []:
        raise RuntimeError(
            "You should specify at least one CNN keys or MLP keys from the cli: "
            "`cnn_keys.encoder=[rgb]` or `mlp_keys.encoder=[state]`"
        )
    if (
        len(set(cfg.cnn_keys.encoder).intersection(set(cfg.cnn_keys.decoder))) == 0
        and len(set(cfg.mlp_keys.encoder).intersection(set(cfg.mlp_keys.decoder))) == 0
    ):
        raise RuntimeError("The CNN keys or the MLP keys of the encoder and decoder must not be disjointed")
    if len(set(cfg.cnn_keys.decoder) - set(cfg.cnn_keys.encoder)) > 0:
        raise RuntimeError("The CNN keys of the decoder must be contained in the encoder ones")
    if len(set(cfg.mlp_keys.decoder) - set(cfg.mlp_keys.encoder)) > 0:
        raise RuntimeError("The MLP keys of the decoder must be contained in the encoder ones")
    if cfg.metric.log_level > 0:
        fabric.print("Encoder CNN keys:", cfg.cnn_keys.encoder)
        fabric.print("Encoder MLP keys:", cfg.mlp_keys.encoder)
        fabric.print("Decoder CNN keys:", cfg.cnn_keys.decoder)
        fabric.print("Decoder MLP keys:", cfg.mlp_keys.decoder)
    cnn_keys, mlp_keys = list(cfg.cnn_keys.encoder), list(cfg.mlp_keys.encoder)
    return SimpleNamespace(
        generator=generator, device=fabric.device, logger=logger, log_dir=log_dir, envs=envs, n_envs=n_envs,
        actions_dim=actions_dim, is_continuous=is_continuous, observation_space=observation_space,
        cnn_keys=cnn_keys, mlp_keys=mlp_keys, obs_keys=cnn_keys + mlp_keys,
    )


def read_resume_checkpoint(fabric, cfg) -> Optional[Dict[str, Any]]:
    """``checkpoint.resume_from``'s tree (None without one); the port resumes
    only from its own checkpoints. Sets ``per_rank_batch_size`` from it."""
    if not cfg.checkpoint.resume_from:
        return None
    from sheeprl_tpu_torch.ckpt import read_manifest

    framework = read_manifest(cfg.checkpoint.resume_from).get("framework")
    if framework != "torch":
        raise ValueError(
            f"checkpoint.resume_from={cfg.checkpoint.resume_from}: written by {framework or 'the JAX package'}; "
            "the port resumes only from its own checkpoints (serve a JAX checkpoint with load_gateway_model)"
        )
    resumed = fabric.load(cfg.checkpoint.resume_from)
    cfg.per_rank_batch_size = int(resumed["batch_size"]) // fabric.world_size
    return resumed


def acting_order(players: Sequence[Any], switch_at_learning_starts: bool, learning_starts: int):
    """``actor_for(update)``: the index of the player that acts at ``update``:
    the first, or with ``switch_at_learning_starts`` the second from
    ``learning_starts`` on (P2E finetuning's switch from the exploration
    actor to the task actor)."""
    if switch_at_learning_starts and len(players) != 2:
        raise ValueError("the actor switch needs two players: the exploration actor's, then the task actor's")
    if not switch_at_learning_starts and len(players) != 1:
        raise ValueError("a run without the actor switch acts with one player")
    return lambda update: int(switch_at_learning_starts and update >= learning_starts)


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
    buffer_kind: str = "dreamer",
    random_prefill: bool = True,
    switch_at_learning_starts: bool = False,
    expl_decay_steps: Optional[int] = None,
    replay_state: Optional[Dict[str, Any]] = None,
    hard_target_updates: bool = True,
) -> Dict[str, Any]:
    """The DreamerV2 loop over an agent built by the caller (:func:`main`,
    the P2E entrypoints): ``players`` are the acting player-fns (one, or the
    exploration and task actors' with ``switch_at_learning_starts``), each
    replayed from its own captured acting step, the player state carried
    over at the switch; ``checkpoint_state()`` gives the checkpoint's
    entries besides the loop's counters (``agent`` and any other),
    ``publish()`` the in-run evaluation's ``agent`` tree; ``test_player``
    plays the final test episode. ``random_prefill=False`` acts with the
    first player from the first step (finetuning). ``replay_state`` is a
    buffer state to restore (resumed, or the exploration run's).
    ``hard_target_updates=False`` is DreamerV1's loop: no target critic
    (every ``tau`` 0) and no pretraining burst (``per_rank_gradient_steps``
    at ``learning_starts`` too)."""
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
        cfg,
        fabric,
        log_dir,
        n_envs=n_envs,
        kind=buffer_kind,
        obs_keys=obs_keys,
        min_size=8,
        dry_run_size=8,
        sequence_length=int(cfg.per_rank_sequence_length),
    )
    episode_buffer = isinstance(rb, EpisodeBuffer)
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

    # First observation: a zero-action is_first row
    # env i of rank r is JAX's env r·n_envs + i: its seed is the run's seed plus that index
    o = envs.reset(seed=cfg.seed + fabric.global_rank * n_envs)[0]
    obs = prepare_obs(o, cnn_keys, mlp_keys, n_envs)
    act_width = int(np.sum(actions_dim))
    step_data = {k: obs[k][None] for k in obs_keys}
    step_data["dones"] = np.zeros((1, n_envs, 1), np.float32)
    step_data["actions"] = np.zeros((1, n_envs, act_width), np.float32)
    step_data["rewards"] = np.zeros((1, n_envs, 1), np.float32)
    step_data["is_first"] = np.ones((1, n_envs, 1), np.float32)
    rb.add(step_data)
    # the acting steps: the player state lives in their static buffers; an env
    # that ended has its row zeroed at the next acting step
    actings = [
        ExplorationStep(player_fns, n_envs, {k: obs[k] for k in obs_keys}, cnn_keys, generator, device)
        for player_fns in players
    ]
    acting_index = actor_for(start_step)
    reset_mask = np.zeros((n_envs, 1), np.float32)

    seconds = PhaseSeconds("env", "act", "sample", "train", "checkpoint", "test")
    counters = {"updates": 0, "player_steps": 0, "random_steps": 0, "gradient_steps": 0, "train_bursts": 0}
    player_steps_by_actor = [0] * len(players)
    switched_at = None
    checkpoint_path = None

    def env_step(actions: np.ndarray, real_actions: np.ndarray) -> Dict[str, np.ndarray]:
        """Step the envs, store the row, reset rows for envs that ended;
        returns the player's next observation and marks the ended envs in
        ``reset_mask``."""
        nonlocal policy_step
        policy_step += n_envs * world_size
        # The next row's is_first mirrors the previous dones
        step_data["is_first"] = step_data["dones"].copy()
        with span("Time/env_interaction_time", SumMetric(), phase="env"):
            o, rewards, terminated, truncated, infos = envs.step(real_actions.reshape(envs.action_space.shape))
        dones = np.logical_or(terminated, truncated).astype(np.float32)
        if "restart_on_exception" in infos:
            for i, env_roe in enumerate(infos["restart_on_exception"]):
                if env_roe and not dones[i]:
                    if not episode_buffer:
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

        # Save the real next observation
        dones_idxes = np.nonzero(dones.reshape(-1))[0].tolist()
        real_next_obs = {k: np.array(v) for k, v in o.items()}
        if "final_obs" in infos:
            for idx in dones_idxes:
                fo = infos["final_obs"][idx]
                if fo is not None:
                    for k in real_next_obs:
                        if k in fo:
                            real_next_obs[k][idx] = np.asarray(fo[k])

        # Row t holds the action that led to observation t
        obs_row = prepare_obs(real_next_obs, cnn_keys, mlp_keys, n_envs)
        for k in obs_keys:
            step_data[k] = obs_row[k][None]
        step_data["dones"] = dones.reshape(1, n_envs, 1)
        step_data["actions"] = actions.reshape(1, n_envs, -1).astype(np.float32)
        step_data["rewards"] = clip_rewards_fn(np.asarray(rewards, np.float32).reshape(n_envs, 1))[None]
        rb.add(step_data)

        # The player continues from the autoreset observation
        new_obs = prepare_obs(o, cnn_keys, mlp_keys, n_envs)
        if dones_idxes:
            reset_obs = prepare_obs({k: v[dones_idxes] for k, v in o.items()}, cnn_keys, mlp_keys, len(dones_idxes))
            reset_data = {k: reset_obs[k][None] for k in obs_keys}
            reset_data["dones"] = np.zeros((1, len(dones_idxes), 1), np.float32)
            reset_data["actions"] = np.zeros((1, len(dones_idxes), act_width), np.float32)
            reset_data["rewards"] = np.zeros((1, len(dones_idxes), 1), np.float32)
            reset_data["is_first"] = np.ones_like(reset_data["dones"])
            rb.add(reset_data, dones_idxes)
            step_data["dones"][:, dones_idxes] = 0.0
            reset_mask[dones_idxes] = 1.0
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
                    actions_t = actings[index]({k: obs[k] for k in obs_keys}, reset_mask, expl_amount)
                    reset_mask[:] = 0.0
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
            pretrain = hard_target_updates and last == learning_starts
            n_samples = cfg.algo.per_rank_pretrain_steps if pretrain else cfg.algo.per_rank_gradient_steps
            metrics = None
            if n_samples > 0:
                with seconds.phase("sample"):
                    local_data = staging.sample_device(
                        cfg.per_rank_batch_size,
                        sequence_length=cfg.per_rank_sequence_length,
                        n_samples=n_samples,
                    )
                taus = tau_schedule(
                    n_samples, counters["gradient_steps"], cfg.algo.critic.target_network_update_freq,
                    tau=1.0, first_hard=False,
                ) if hard_target_updates else np.zeros(n_samples, np.float32)
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
                    # one graph replay a gradient step on the card; the metrics (or one
                    # pacing scalar) come back once a burst
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
            test_reward, test_steps = test(test_player, fabric, cfg, log_dir, normalize_fn=normalize_obs)
    if logger is not None:
        logger.close()
    return _run_result(
        counters, policy_step, inrun, test_steps, test_reward, log_dir, logger, checkpoint_path, seconds, staging,
        train_program, actings, player_steps_by_actor, switched_at,
    )


def _run_result(counters, policy_step, inrun, test_steps, test_reward, log_dir, logger, checkpoint_path, seconds,
                staging, train_program, actings, player_steps_by_actor, switched_at) -> Dict[str, Any]:
    """A run's result: its loop counters, where its host time went, how its
    steps ran on the card and, with two actors, each one's acting steps and
    the update at which the second took over."""
    train_steps = [] if train_program.static is None else [train_program.static.step]
    return {
        **counters,
        "policy_steps": policy_step,
        "player_steps_by_actor": player_steps_by_actor,
        "actor_switched_at": switched_at,
        "inrun_publishes": 0 if inrun is None else inrun.publishes,
        "test_steps": test_steps,
        "test_reward": test_reward,
        "log_dir": log_dir,
        "event_file": None if logger is None else logger.path,
        "checkpoint": checkpoint_path,
        "seconds": seconds,
        "prefetch": {"hits": staging.prefetch_hits, "misses": staging.prefetch_misses},
        "graphs": {
            "train": _graph_counts(train_steps),
            "act": _graph_counts([a.step for a in actings]),
        },
    }


@register_algorithm()
def main(fabric, cfg) -> Dict[str, Any]:
    """The DreamerV2 training run (:func:`train_loop`). Returns its loop
    counters, where its host time went (seconds per phase; the train phase
    ends synchronised with the device) and how its steps ran on the card
    (eager warm-up calls and graph replays)."""
    _unsupported(cfg)
    # These arguments cannot be changed
    cfg.env.screen_size = 64
    cfg.env.frame_stack = 1
    run = open_run(fabric, cfg)
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
    )

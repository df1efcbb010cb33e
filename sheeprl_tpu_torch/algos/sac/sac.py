"""SAC training (counterpart of ``sheeprl_tpu/algos/sac/sac.py``): the
gradient step (:func:`build_train_fn`), the off-policy loop the SAC family
shares (:func:`open_run`, :func:`train_loop`) and the training run
(:func:`main`, registered as ``sac``).

The gradient step keeps the JAX ``one_step``'s order:

1. the critics, against the TD target of the target critics at the
   actor's squashed sample of the next observation (the min over the
   ensemble less ``alpha · log_prob``); their Adam step;
2. the target EMA ``t ← τ·c + (1−τ)·t`` on the fresh critics, gated by the
   update's ``do_ema`` with no host branch: the step's ``gates`` hold
   ``(τ, 1−τ)`` or ``(0, 1)``;
3. the actor, against the min of the fresh critics at its own sample; its
   Adam step;
4. ``log_alpha``, on the actor's detached log-prob; its Adam step.

Its noise (the two samples' standard normals) is an input, drawn from the
run's generator outside the step. :class:`StepProgram` replays the step
from one CUDA graph a gradient step on the card (the JAX program scans the
G steps of a burst in one dispatch; here the host issues one replay a step,
with no host synchronisation inside a burst) and returns the burst's mean
metrics as one device tensor.

The loop (:func:`train_loop`) acts on the Python plane with
:class:`ActingStep` (the actor's sample, one graph replay a step) or, with
``env.backend=jax``, collects on the device with the rollout engine into
the device ring (:mod:`sheeprl_tpu_torch.envs.rollout`); the family's
``train_round`` runs the gradient steps its cadence asks for. The checkpoint holds the JAX tree's entries: ``agent`` (each
module's ``state_dict`` and ``log_alpha``), ``opt_states``, ``update``,
``batch_size``, ``last_log`` and ``last_checkpoint``.
"""

from __future__ import annotations

import os
import warnings
from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import (
    _graph_counts,
    _no_param_grads,
    adam_for,
    give_zero_grads,
    load_optimizer_state,
    read_resume_checkpoint,
)
from sheeprl_tpu_torch.algos.sac.agent import action_bounds, build_agent_state, greedy_action, squash_sample
from sheeprl_tpu_torch.algos.sac.loss import critic_loss, entropy_loss, policy_loss
from sheeprl_tpu_torch.algos.sac.utils import concat_obs, test
from sheeprl_tpu_torch.ckpt import preemption_requested, should_checkpoint, warn_checkpoint_rounding
from sheeprl_tpu_torch.config.instantiate import instantiate
from sheeprl_tpu_torch.data.device_ring import DeviceRingTransitions
from sheeprl_tpu_torch.data.staging import RingStaging, make_replay_staging
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.vector import make_vector_env, resolve_backend
from sheeprl_tpu_torch.evals.inrun import maybe_start_inrun_eval
from sheeprl_tpu_torch.obs.counters import add_rollout_burst, add_train_burst
from sheeprl_tpu_torch.obs.learn import LearnTap, learn_tap, probe_losses, probe_optimizer, tapped
from sheeprl_tpu_torch.obs.perf import PhaseSeconds, log_sps_metrics, register_step_cost
from sheeprl_tpu_torch.obs.prof.capture import profile_tick
from sheeprl_tpu_torch.obs.spans import span
from sheeprl_tpu_torch.replay import make_replay_buffer
from sheeprl_tpu_torch.train.graphs import CapturedStep
from sheeprl_tpu_torch.utils.logger import create_tensorboard_logger
from sheeprl_tpu_torch.utils.metric import MetricAggregator, SumMetric
from sheeprl_tpu_torch.utils.optim import Adam, set_lr
from sheeprl_tpu_torch.utils.registry import register_algorithm
from sheeprl_tpu_torch.utils.utils import save_configs

__all__ = [
    "LOSS_NAMES",
    "ActingStep",
    "StepProgram",
    "agent_state_dict",
    "build_optimizers_and_state",
    "build_train_fn",
    "ema_gates",
    "load_agent_state",
    "main",
    "open_run",
    "train_loop",
    "unsupported",
]

#: the step's metrics, in the order of its stacked output
LOSS_NAMES = ("Loss/value_loss", "Loss/policy_loss", "Loss/alpha_loss")
_MODULES = ("actor", "critics")


# ---------------------------------------------------------------------------
# captured steps
# ---------------------------------------------------------------------------


class StepProgram:
    """``program(state, data, noise=None, gates=None)`` is one eager
    gradient step; ``program.burst(state, data_stack, gates, noise=None)``
    runs ``len(data_stack)`` steps, each replayed from the captured step on
    the card. Both return the metrics as one stacked device tensor (the
    burst's: their mean over its steps).

    ``body(state, data, noise, gates)`` updates ``state`` in place and
    returns the stacked metrics, with no host branch on device values and no
    host synchronisation; ``draw_noise(state, data, generator, device)``
    gives one step's noise dict; ``prepare(state)`` gives every trained parameter its
    gradient tensor once. ``gates`` is a float32 vector of the step's
    cadence values (the family's; :func:`ema_gates` for SAC). A program
    bursts on one state at one batch shape (``.static`` holds its buffers).
    A body may return ``(metrics, td)``: the step then returns both, and a
    burst keeps its steps' ``td`` stacked in :attr:`last_td` (a device
    tensor, ``[G, B, 1]`` for SAC's TD residuals). ``learn_tap`` (an
    ``obs.learn.LearnTap``, or None) records each call's learn probes; a
    burst hands their stack to the sentinel (``train/burst.py``'s feed)."""

    def __init__(self, body, draw_noise, prepare, n_gates: int, learn_tap: Optional[LearnTap] = None):
        self._body = tapped(body, learn_tap)
        self.learn_tap = learn_tap
        self._draw_noise = draw_noise
        self.prepare = prepare
        self.n_gates = int(n_gates)
        self.static: Optional[SimpleNamespace] = None
        self.last_td: Optional[torch.Tensor] = None

    @property
    def step(self) -> Optional[CapturedStep]:
        """The captured step (None before the first burst)."""
        return None if self.static is None else self.static.step

    def calls(self) -> int:
        """The captured step's calls so far, eager and replayed."""
        return 0 if self.static is None else self.static.step.eager_calls + self.static.step.replays

    def __call__(self, state, data, noise=None, gates=None):
        device = data["rewards"].device
        if noise is None:
            noise = self._draw_noise(state, data, state.get("generator"), device)
        self.prepare(state)
        gates = torch.as_tensor(np.asarray(gates, np.float32).reshape(self.n_gates)).to(device)
        out = self._body(state, data, noise, gates)
        if self.learn_tap is not None:
            self.learn_tap.collect()
        return out

    def _static_for(self, state, data_stack) -> SimpleNamespace:
        if self.static is None:
            example = {k: v[0] for k, v in data_stack.items()}
            device = example["rewards"].device
            static = SimpleNamespace(
                state=state,
                data={k: torch.zeros_like(v) for k, v in example.items()},
                noise=self._draw_noise(state, example, None, device),
                gates=torch.zeros(self.n_gates, dtype=torch.float32, device=device),
            )
            self.prepare(state)
            static.step = CapturedStep(lambda: self._body(state, static.data, static.noise, static.gates), device,
                                       train=True)
            self.static = static
        static = self.static
        same = static.state is state and static.data.keys() == data_stack.keys() and all(
            v.shape == data_stack[k].shape[1:] and v.dtype == data_stack[k].dtype for k, v in static.data.items()
        )
        if not same:
            raise ValueError("a StepProgram bursts on one agent state at one batch shape and dtype")
        return static

    def burst(self, state, data_stack, gates, noise: Optional[Sequence[Dict[str, torch.Tensor]]] = None):
        static = self._static_for(state, data_stack)
        n = next(iter(data_stack.values())).shape[0]
        add_train_burst(steps=n, dispatches=n)
        gates = np.array(np.broadcast_to(np.asarray(gates, np.float32), (n, self.n_gates)))
        gates_dev = torch.from_numpy(gates).to(static.gates.device)
        total, tds = None, []
        for i in range(n):
            for k, v in static.data.items():
                v.copy_(data_stack[k][i], non_blocking=True)
            drawn = noise[i] if noise is not None else self._draw_noise(state, static.data, state.get("generator"),
                                                                         static.gates.device)
            for k, v in static.noise.items():
                v.copy_(drawn[k])
            static.gates.copy_(gates_dev[i])
            out = static.step()
            if self.learn_tap is not None:
                self.learn_tap.collect()
            if isinstance(out, tuple):
                out, td = out
                tds.append(td.clone())
            total = out.clone() if total is None else total.add_(out)
        self.last_td = torch.stack(tds) if tds else None
        if self.learn_tap is not None:
            self.learn_tap.flush()
        return total / n


class ActingStep:
    """The training loop's acting step: ``policy(obs, eps) -> actions`` over
    static buffers (the observation rows, the standard normals), replayed
    from a CUDA graph on the card; each call copies the observation in and
    draws the noise from ``generator`` (or copies the given one)."""

    def __init__(self, policy, obs_example: Mapping[str, np.ndarray], act_dim: int,
                 generator: Optional[torch.Generator], device):
        self.device = torch.device(device)
        self._generator = generator
        self.obs = {k: torch.zeros(np.shape(v), dtype=torch.from_numpy(np.asarray(v)).dtype, device=self.device)
                    for k, v in obs_example.items()}
        n = int(np.shape(next(iter(obs_example.values())))[0])
        self.eps = torch.zeros((n, int(act_dim)), device=self.device)
        self.step = CapturedStep(torch.no_grad()(lambda: policy(self.obs, self.eps)), self.device,
                                 name="act")

    def __call__(self, obs: Mapping[str, np.ndarray], eps: Optional[torch.Tensor] = None) -> np.ndarray:
        for k, v in obs.items():
            self.obs[k].copy_(torch.from_numpy(np.ascontiguousarray(v)))
        if eps is None:
            eps = torch.randn(self.eps.shape, generator=self._generator, device=self.device)
        self.eps.copy_(eps)
        add_rollout_burst(act_dispatches=1)
        return self.step().cpu().numpy()


# ---------------------------------------------------------------------------
# the SAC step
# ---------------------------------------------------------------------------


def ema_gates(do_ema: bool, tau: float) -> np.ndarray:
    """``(τ, 1−τ)`` when the EMA is on, ``(0, 1)`` when off, as float32: the
    JAX step's Python-float weights, and its ``where(do_ema, ema, t)``."""
    return np.asarray([tau, 1.0 - tau] if do_ema else [0.0, 1.0], np.float32)


@torch.no_grad()
def ema_update(target: torch.nn.Module, source: torch.nn.Module, w: torch.Tensor, keep: torch.Tensor) -> None:
    """``t ← w·s + keep·t`` over every parameter, in place."""
    params = list(target.parameters())
    torch._foreach_mul_(params, keep)
    torch._foreach_add_(params, torch._foreach_mul(list(source.parameters()), w))


def build_optimizers_and_state(cfg, agent: Dict[str, Any], generator=None) -> Dict[str, Any]:
    """The agent's modules and one ``utils.optim.Adam`` each for the actor,
    the critics and ``log_alpha`` (the JAX ``opt_states`` keys ``actor``,
    ``qf``, ``alpha``)."""
    o = cfg.algo.alpha.optimizer
    opt = {
        "actor": adam_for(agent["actor"], cfg.algo.actor.optimizer),
        "qf": adam_for(agent["critics"], cfg.algo.critic.optimizer),
        "alpha": Adam([agent["log_alpha"]], lr=float(o.lr), betas=tuple(o.betas), eps=float(o.eps),
                      weight_decay=float(o.weight_decay)),
    }
    return {**agent, "opt": opt, "generator": generator}


def _prepare(state: Dict[str, Any]) -> None:
    give_zero_grads([state["actor"], state["critics"]])
    if state["log_alpha"].grad is None:
        state["log_alpha"].grad = torch.zeros_like(state["log_alpha"])


def _zero_grads(params) -> None:
    with torch.no_grad():
        torch._foreach_zero_([p.grad for p in params])


def actor_and_alpha_update(state, actor_loss_fn, alpha, target_entropy: float, gate=None):
    """The actor's loss (``actor_loss_fn() -> (loss, log_prob)``) and its
    step, then ``log_alpha``'s on the detached log-prob; with ``gate`` both
    steps apply only where it is on. Returns the two losses."""
    opt = state["opt"]
    actor_loss, logprob = actor_loss_fn()
    actor_loss.backward()
    probed = probe_optimizer("actor", opt["actor"])
    opt["actor"].step(gate=gate)
    probed()
    alpha_loss = entropy_loss(state["log_alpha"], logprob.detach(), target_entropy)
    alpha_loss.backward()
    probed = probe_optimizer("alpha", opt["alpha"])
    opt["alpha"].step(gate=gate)
    probed()
    return actor_loss.detach(), alpha_loss.detach()


def build_train_fn(cfg, act_dim: int, target_entropy: float, emit_td: bool = False) -> StepProgram:
    """The gradient step at ``cfg``'s settings as a :class:`StepProgram`.
    ``state`` also holds the action bounds (``action_scale``,
    ``action_bias``). ``data`` holds ``[B, ...]`` device tensors
    ``observations``, ``actions``,
    ``rewards``, ``dones`` and ``next_observations``; ``noise`` is
    ``{"next": eps, "actor": eps}`` (``[B, A]`` standard normals); ``gates``
    is :func:`ema_gates`'s. Returns ``LOSS_NAMES``' values stacked; with
    ``emit_td`` (``replay.strategy=td_priority``'s writeback) also each row's
    TD residual ``min_i Q_i(s, a) − y`` of the critics before their update,
    ``[B, 1]``, from the critic loss's own forward."""
    gamma = float(cfg.algo.gamma)
    n_critics = int(cfg.algo.critic.n)

    def body(state, data, noise, gates):
        actor, critics, targets, log_alpha, opt = (state[k] for k in ("actor", "critics", "target_critics",
                                                                       "log_alpha", "opt"))
        scale, bias = state["action_scale"], state["action_bias"]
        _zero_grads([p for m in (actor, critics) for p in m.parameters()] + [log_alpha])
        alpha = torch.exp(log_alpha.detach())
        with torch.no_grad():
            next_mean, next_std = actor(data["next_observations"])
            next_actions, next_logprob = squash_sample(next_mean, next_std, noise["next"], scale, bias)
            target_q = targets(data["next_observations"], next_actions)
            min_target = torch.amin(target_q, dim=-1, keepdim=True) - alpha * next_logprob
            td_target = data["rewards"] + (1.0 - data["dones"]) * gamma * min_target

        q = critics(data["observations"], data["actions"])
        qf_loss = critic_loss(q, td_target, n_critics)
        qf_loss.backward()
        probed = probe_optimizer("critic", opt["qf"])
        opt["qf"].step()
        probed()
        ema_update(targets, critics, gates[0], gates[1])

        def actor_loss_fn():
            mean, std = actor(data["observations"])
            actions, logprob = squash_sample(mean, std, noise["actor"], scale, bias)
            with _no_param_grads(critics):
                min_q = torch.amin(critics(data["observations"], actions), dim=-1, keepdim=True)
            return policy_loss(alpha, logprob, min_q), logprob

        actor_loss, alpha_loss = actor_and_alpha_update(state, actor_loss_fn, alpha, target_entropy)
        probe_losses(qf_loss, actor_loss, alpha_loss)
        metrics = torch.stack([qf_loss.detach(), actor_loss, alpha_loss])
        if emit_td:
            return metrics, torch.amin(q.detach(), dim=-1, keepdim=True) - td_target
        return metrics

    def draw_noise(state, data, generator, device):
        batch = data["rewards"].shape[0]
        return {k: torch.randn((batch, act_dim), generator=generator, device=device) for k in ("next", "actor")}

    return StepProgram(body, draw_noise, _prepare, n_gates=2, learn_tap=learn_tap())


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def agent_state_dict(state: Dict[str, Any], modules: Sequence[str]) -> Dict[str, Any]:
    """The checkpoint's ``agent`` tree (each module's ``state_dict``, and
    ``log_alpha``) and its ``opt_states`` (each optimizer's per-parameter
    state), as ``(agent, opt_states)``."""
    agent: Dict[str, Any] = {name: state[name].state_dict() for name in modules}
    agent["log_alpha"] = state["log_alpha"].detach()
    opt_states = {name: {"state": opt.state_dict()["state"]} for name, opt in state["opt"].items()}
    return agent, opt_states


def load_agent_state(state: Dict[str, Any], agent: Mapping[str, Any], opt_states: Mapping[str, Any],
                     modules: Sequence[str]) -> None:
    """Load :func:`agent_state_dict`'s trees (numpy leaves) into ``state`` in place."""
    for name in modules:
        state[name].load_state_dict({k: torch.as_tensor(v) for k, v in agent[name].items()})
    with torch.no_grad():
        state["log_alpha"].copy_(torch.as_tensor(np.asarray(agent["log_alpha"])).reshape(state["log_alpha"].shape))
    for name, opt in state["opt"].items():
        load_optimizer_state(opt, opt_states[name])


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------


def unsupported(cfg, family: str) -> None:
    """Raise for the options whose layers the port does not have yet."""
    if "minedojo" in str(cfg.env.wrapper.get("_target_", "") or "").lower():
        raise ValueError(f"MineDojo is not currently supported by {family} agent")
    if resolve_backend(cfg) == "python" and int(cfg.env.get("act_burst", 1) or 1) != 1:
        raise NotImplementedError(
            "env.act_burst>1 on the Python plane: burst acting amortises TPU dispatches; the port replays each "
            "acting step from a CUDA graph (on env.backend=jax it is the rollout engine's burst length)"
        )


def open_run(fabric, cfg, family: str, *, allow_device_envs: bool = False) -> SimpleNamespace:
    """The run's seeded generator, logger and saved config, and its envs:
    the Python vector env, or with ``env.backend=jax`` (``allow_device_envs``)
    the device env the rollout engine will step. Checks the action space
    (a Box) and the observation space (a Dict)."""
    unsupported(cfg, family)
    generator, _ = fabric.seed_everything(cfg.seed)
    logger, log_dir = create_tensorboard_logger(cfg)
    fabric.logger = logger
    if logger is not None:
        logger.log_hyperparams(cfg.as_dict() if hasattr(cfg, "as_dict") else dict(cfg))
    if fabric.is_global_zero:
        save_configs(cfg, log_dir)
    n_envs = int(cfg.env.num_envs) * fabric.world_size
    backend = resolve_backend(cfg)
    envs = device_env = None
    if backend == "jax":
        if not allow_device_envs:
            make_vector_env(cfg, fabric, log_dir)  # raises, naming the backend
        from sheeprl_tpu_torch.envs.rollout import make_device_env

        device_env = make_device_env(cfg.env.id, n_envs, fabric.device, cfg.env.max_episode_steps)
        action_space, observation_space = device_env.action_space, device_env.observation_space
    else:
        envs = make_vector_env(cfg, fabric, log_dir)
        action_space, observation_space = envs.single_action_space, envs.single_observation_space
    if not isinstance(action_space, spaces.Box):
        raise ValueError(f"Only continuous action space is supported for the {family} agent")
    if not isinstance(observation_space, spaces.Dict):
        raise RuntimeError(f"Unexpected observation type, should be of type Dict, got: {observation_space}")
    scale, bias = action_bounds(action_space)
    return SimpleNamespace(
        generator=generator, device=fabric.device, logger=logger, log_dir=log_dir, envs=envs, device_env=device_env,
        backend=backend, n_envs=n_envs, action_space=action_space, observation_space=observation_space,
        act_dim=int(np.prod(action_space.shape)), action_scale=scale, action_bias=bias,
    )


def check_vector_obs(cfg, observation_space, family: str) -> int:
    """SAC and DroQ read vector keys only: drop the CNN keys with a warning,
    check the MLP keys, return the concatenated observation's width."""
    if len(cfg.cnn_keys.encoder) > 0:
        warnings.warn(f"{family} algorithm cannot allow to use images as observations, the CNN keys will be ignored")
        cfg.cnn_keys.encoder = []
    if len(cfg.mlp_keys.encoder) == 0:
        raise RuntimeError("You should specify at least one MLP key for the encoder: `mlp_keys.encoder=[state]`")
    for k in cfg.mlp_keys.encoder:
        if len(observation_space[k].shape) > 1:
            raise ValueError(
                f"Only environments with vector-only observations are supported by the {family} agent. "
                f"Provided environment: {cfg.env.id}"
            )
    if cfg.metric.log_level > 0:
        print("Encoder MLP keys:", cfg.mlp_keys.encoder)
    return int(sum(np.prod(observation_space[k].shape) for k in cfg.mlp_keys.encoder))


def vector_rows(cfg) -> Callable[[Mapping[str, np.ndarray], int], Dict[str, np.ndarray]]:
    """SAC's and DroQ's stored observation: the MLP keys concatenated, ``observations``."""
    keys = list(cfg.mlp_keys.encoder)
    return lambda o, n: {"observations": concat_obs(o, keys, n)}


def train_loop(
    fabric,
    cfg,
    run: SimpleNamespace,
    state: Dict[str, Any],
    resumed: Optional[Dict[str, Any]],
    *,
    obs_rows: Callable[[Mapping[str, np.ndarray], int], Dict[str, np.ndarray]],
    stored_keys: Sequence[str],
    acting_policy: Callable,
    train_round: Callable[[Any, int, int, int, Dict[str, int]], Optional[torch.Tensor]],
    loss_names: Sequence[str],
    checkpoint_state: Callable[[], Dict[str, Any]],
    publish: Callable[[], Dict[str, Any]],
    greedy: Callable[[Mapping[str, np.ndarray]], np.ndarray],
    programs: Sequence[StepProgram],
) -> Dict[str, Any]:
    """The SAC family's loop. Per update: one acting step of the ``n`` envs
    (a random action up to ``learning_starts``; the actor's sample after,
    ``acting_policy(obs_rows, eps)`` replayed from a graph) or, with
    ``env.backend=jax``, one rollout-engine burst of ``env.act_burst``
    updates (random bursts clamped at ``learning_starts``); then
    ``train_round(staging, first, last, learning_starts, counters)``, the
    family's gradient steps for updates ``first..last`` (their stacked mean
    metrics, or None). Metrics stay on the device until a log boundary.
    ``obs_rows(o, n)`` turns an env observation into the rows stored under
    ``stored_keys`` (each ``next_<key>`` stored beside it unless
    ``buffer.sample_next_obs``); ``greedy`` plays the final test episode."""
    world_size = fabric.world_size
    generator, device, logger, log_dir, n_envs = run.generator, run.device, run.logger, run.log_dir, run.n_envs
    aggregator = None
    if not MetricAggregator.disabled:
        aggregator = instantiate(cfg.metric.aggregator)
    sample_next_obs = bool(cfg.buffer.sample_next_obs)
    rb = make_replay_buffer(cfg, fabric, log_dir, n_envs=n_envs, obs_keys=tuple(stored_keys), dry_run_size=1)

    engine = None
    if run.backend == "jax":
        from sheeprl_tpu_torch.envs.rollout import RolloutEngine

        if hasattr(rb, "plan_burst"):
            raise ValueError("env.backend=jax collects into the device ring, which samples one ring uniformly: "
                             "replay.shards and replay.strategy need env.backend=python")
        if not cfg.buffer.get("device_ring", False):
            warnings.warn("env.backend=jax collects straight into the device ring; enabling it "
                          "(buffer.device_ring was off)")
        ring = DeviceRingTransitions(rb, device, torch.Generator(device=device).manual_seed(int(cfg.seed)))
        engine = RolloutEngine(run.device_env, generator,
                               policy=lambda obs, eps: acting_policy({"observations": obs}, eps), ring=ring,
                               store_next_obs=not sample_next_obs)
        staging, rb = RingStaging(ring), ring
    else:
        staging = make_replay_staging(cfg, fabric, rb, seed=cfg.seed)
    if resumed is not None and cfg.buffer.get("checkpoint", False) and "rb" in resumed:
        rb.load_state_dict(resumed["rb"])

    start_step = int(resumed["update"]) // world_size if resumed is not None else 1
    # fault injection (metric.telemetry.learn.inject_lr_spike_*): every optimizer's rate multiplied once, at the
    # update given; it drives the divergence sentinel's acceptance tests and is never on in a real run
    learn_cfg = (cfg.metric.get("telemetry", None) or {}).get("learn", None) or {}
    lr_spike_at = learn_cfg.get("inject_lr_spike_at", None)
    lr_spike_factor = float(learn_cfg.get("inject_lr_spike_factor", 0) or 0)
    policy_step = int(resumed["update"]) * cfg.env.num_envs if resumed is not None else 0
    last_log = int(resumed["last_log"]) if resumed is not None else 0
    last_checkpoint = int(resumed["last_checkpoint"]) if resumed is not None else 0
    policy_steps_per_update = int(n_envs)
    num_updates = int(cfg.total_steps // policy_steps_per_update) if not cfg.dry_run else 1
    learning_starts = cfg.algo.learning_starts // policy_steps_per_update if not cfg.dry_run else 0
    if cfg.checkpoint.resume_from and not cfg.buffer.get("checkpoint", False):
        learning_starts += start_step
    if cfg.metric.log_level > 0 and cfg.metric.log_every % policy_steps_per_update != 0:
        warnings.warn(
            f"The metric.log_every parameter ({cfg.metric.log_every}) is not a multiple of the "
            f"policy_steps_per_update value ({policy_steps_per_update}), so the metrics will be logged at the "
            "nearest greater multiple of the policy_steps_per_update value."
        )
    warn_checkpoint_rounding(cfg, policy_steps_per_update)
    act_burst = max(int(cfg.env.get("act_burst", 1) or 1), 1)

    seconds = PhaseSeconds("env", "act", "sample_and_train", "checkpoint", "test")
    counters = {"updates": 0, "player_steps": 0, "random_steps": 0, "gradient_steps": 0, "train_bursts": 0,
                "ema_steps": 0}
    episode_returns: List[float] = []
    loss_sum, loss_count = None, 0
    train_step = last_train = 0
    checkpoint_path = None

    def log_episode(step: int, env_i: int, ep_rew: float, ep_len: float) -> None:
        episode_returns.append(ep_rew)
        if cfg.metric.log_level > 0:
            if aggregator and not aggregator.disabled:
                aggregator.update("Rewards/rew_avg", ep_rew)
                aggregator.update("Game/ep_len_avg", ep_len)
            fabric.print(f"Rank-0: policy_step={step}, reward_env_{env_i}={ep_rew}")

    box: Dict[str, Any] = {}
    acting = None
    if run.backend == "python":
        o = run.envs.reset(seed=cfg.seed)[0]
        box["obs"] = obs_rows(o, n_envs)
        acting = ActingStep(acting_policy, box["obs"], run.act_dim, generator, device)

    def env_step(actions: np.ndarray) -> None:
        nonlocal policy_step
        policy_step += n_envs
        with span("Time/env_interaction_time", SumMetric(), phase="env"):
            next_o, rewards, terminated, truncated, infos = run.envs.step(actions.reshape(run.envs.action_space.shape))
        dones = np.logical_or(terminated, truncated)
        if "final_info" in infos:
            fi = infos["final_info"]
            if isinstance(fi, dict) and "episode" in fi:
                for i in np.nonzero(np.asarray(fi.get("_episode", []), dtype=bool))[0]:
                    log_episode(policy_step, int(i), float(fi["episode"]["r"][i]), float(fi["episode"]["l"][i]))
        next_rows = obs_rows(next_o, n_envs)
        step_data = {k: v[None] for k, v in box["obs"].items()}
        step_data["actions"] = np.asarray(actions, np.float32).reshape(1, n_envs, -1)
        step_data["rewards"] = np.asarray(rewards, np.float32).reshape(1, n_envs, 1)
        step_data["dones"] = np.asarray(dones, np.float32).reshape(1, n_envs, 1)
        if not sample_next_obs:
            # the real next observation: an ended env's final_obs, not its reset one
            real_next = {k: v.copy() for k, v in next_rows.items()}
            if "final_obs" in infos:
                for idx, final_obs in enumerate(infos["final_obs"]):
                    if final_obs is not None:
                        for k, v in obs_rows({kk: np.asarray(vv)[None] for kk, vv in final_obs.items()}, 1).items():
                            real_next[k][idx] = v[0]
            for k, v in real_next.items():
                step_data[f"next_{k}"] = v[None]
        rb.add(step_data)
        box["obs"] = next_rows

    inrun = maybe_start_inrun_eval(fabric, cfg, log_dir)
    update = start_step
    while update <= num_updates:
        if engine is not None:
            with seconds.phase("env"):
                random_phase = update <= learning_starts
                boundary = min(learning_starts, num_updates) if random_phase else num_updates
                n_act = max(min(act_burst, boundary - update + 1), 1)
                with span("Time/rollout_time", SumMetric(), phase="rollout"):
                    stats = engine.collect(n_act, random_actions=random_phase)
                _, done_b, ep_ret_b, ep_len_b = (s.cpu().numpy() for s in stats)
                for t_i, env_i in zip(*np.nonzero(done_b)):
                    log_episode(policy_step + (int(t_i) + 1) * n_envs, int(env_i), float(ep_ret_b[t_i, env_i]),
                                float(ep_len_b[t_i, env_i]))
                policy_step += n_envs * n_act
                counters["random_steps" if random_phase else "player_steps"] += n_act
        elif update <= learning_starts:
            n_act = 1
            with seconds.phase("env"):
                env_step(np.asarray(run.envs.action_space.sample()))
            counters["random_steps"] += 1
        else:
            n_act = 1
            with span("Time/rollout_time", SumMetric(), phase="rollout"):
                with seconds.phase("act"):
                    actions = acting(box["obs"])
                with seconds.phase("env"):
                    env_step(actions)
            counters["player_steps"] += 1
        first = update
        update += n_act
        last = update - 1
        counters["updates"] += n_act

        calls = sum(p.calls() for p in programs)
        if lr_spike_at is not None and lr_spike_factor and first <= int(lr_spike_at) <= last:
            lr_spike_at = None  # fires exactly once
            for opt in state["opt"].values():
                set_lr(opt, opt.param_groups[0]["lr"] * lr_spike_factor)
        with seconds.phase("sample_and_train"), span(
            "Time/train_time", SumMetric(sync_on_compute=cfg.metric.sync_on_compute), phase="train"
        ):
            metrics = train_round(staging, first, last, learning_starts, counters)
        if metrics is not None:
            loss_sum = metrics.clone() if loss_sum is None else loss_sum.add_(metrics)
            loss_count += 1
            train_step += world_size
            if first > learning_starts:  # a round past the catch-up burst: its step calls are a train step's
                register_step_cost(programs[0].step, dispatches_per_step=sum(p.calls() for p in programs) - calls,
                                   world_size=world_size)

        if inrun is not None and last >= learning_starts and inrun.due(policy_step):
            inrun.maybe_publish(policy_step, publish())

        if cfg.metric.log_level > 0 and (policy_step - last_log >= cfg.metric.log_every or last == num_updates):
            if aggregator and not aggregator.disabled:
                if loss_sum is not None:
                    for name, value in zip(loss_names, (loss_sum / loss_count).tolist()):
                        if name in aggregator:
                            aggregator.update(name, value)
                if logger is not None:
                    logger.log_metrics(aggregator.compute(), policy_step)
                aggregator.reset()
            loss_sum, loss_count = None, 0
            log_sps_metrics(logger, policy_step=policy_step, last_log=last_log, train_step=train_step,
                            last_train=last_train, world_size=world_size, action_repeat=cfg.env.action_repeat)
            profile_tick(policy_step=policy_step, world_size=world_size)
            last_log, last_train = policy_step, train_step

        if should_checkpoint(cfg, policy_step, last_checkpoint, last, num_updates):
            with seconds.phase("checkpoint"), span("Time/checkpoint_time", phase="checkpoint"):
                last_checkpoint = policy_step
                ckpt_state = {
                    **checkpoint_state(),
                    "update": last * world_size,
                    "batch_size": cfg.per_rank_batch_size * world_size,
                    "last_log": last_log,
                    "last_checkpoint": last_checkpoint,
                }
                checkpoint_path = os.path.join(log_dir, "checkpoint", f"ckpt_{policy_step}_{fabric.global_rank}")
                fabric.call("on_checkpoint_coupled", ckpt_path=checkpoint_path, state=ckpt_state,
                            replay_buffer=rb if cfg.buffer.get("checkpoint", False) else None)
            if preemption_requested():
                break

    if inrun is not None:
        inrun.close()
    staging.close()
    if run.envs is not None:
        run.envs.close()
    test_reward, test_steps = None, 0
    if fabric.is_global_zero and cfg.algo.get("run_test", True) and not preemption_requested():
        with seconds.phase("test"):
            test_reward, test_steps = test(greedy, fabric, cfg, log_dir, device_env=engine is not None)
    if logger is not None:
        logger.close()
    train_steps = [p.static.step for p in programs if p.static is not None]
    result = {
        **counters,
        "policy_steps": policy_step,
        "learning_starts": learning_starts,
        "episode_returns": episode_returns,
        "inrun_publishes": 0 if inrun is None else inrun.publishes,
        "test_steps": test_steps,
        "test_reward": test_reward,
        "log_dir": log_dir,
        "event_file": None if logger is None else logger.path,
        "checkpoint": checkpoint_path,
        "seconds": seconds,
        "prefetch": {"hits": staging.prefetch_hits, "misses": staging.prefetch_misses},
        "graphs": {"train": _graph_counts(train_steps), "act": _graph_counts([] if acting is None else [acting.step])},
    }
    if engine is not None:
        result["engine"] = {"bursts": engine.bursts, "env_steps": engine.env_steps,
                            "graphs": _graph_counts(list(engine.graphs.values())),
                            "ring_rows": int(rb.buffer_size if rb.full else rb.host._pos), "ring_full": rb.full,
                            "ring_capacity": rb.buffer_size}
    return result


# ---------------------------------------------------------------------------
# the SAC run
# ---------------------------------------------------------------------------


def sac_train_round(cfg, program: StepProgram, state: Dict[str, Any], n_envs: int):
    """SAC's gradient steps for updates ``first..last``: from
    ``learning_starts`` on, ``per_rank_gradient_steps`` a covered update,
    plus the catch-up burst of ``learning_starts - 1`` updates' steps when
    the range holds ``learning_starts``; the EMA is on for the whole burst
    when any covered update hits ``ema_every``."""
    per_rank_gradient_steps = int(cfg.algo.per_rank_gradient_steps)
    tau = float(cfg.algo.tau)
    ema_every = int(cfg.algo.critic.target_network_frequency) // int(n_envs) + 1

    def train_round(staging, first: int, last: int, learning_starts: int,
                    counters: Dict[str, int]) -> Optional[torch.Tensor]:
        if last < learning_starts or per_rank_gradient_steps <= 0:
            return None
        training_steps = last - max(first, learning_starts) + 1
        if first <= learning_starts <= last:
            training_steps += learning_starts - 1
        g_total = training_steps * per_rank_gradient_steps
        batch = staging.sample_device(cfg.per_rank_batch_size, n_samples=g_total,
                                      sample_next_obs=cfg.buffer.sample_next_obs)
        do_ema = any(u % ema_every == 0 for u in range(first, last + 1))
        metrics = program.burst(state, batch, ema_gates(do_ema, tau))
        if program.last_td is not None:
            # the prioritized writeback: the [G, B, 1] residuals in the last plan's flat row order, one copy a burst
            staging.update_priorities(np.abs(program.last_td.cpu().numpy()).reshape(-1))
        counters["gradient_steps"] += g_total
        counters["ema_steps"] += g_total if do_ema else 0
        counters["train_bursts"] += 1
        return metrics

    return train_round


def needs_td_writeback(cfg) -> bool:
    """The strategy writes TD priorities back (``replay.strategy=td_priority``)."""
    from sheeprl_tpu_torch.replay import get_strategy, replay_config

    return bool(get_strategy(str(replay_config(cfg).get("strategy", "uniform") or "uniform")).needs_writeback)


def sac_acting_policy(state: Dict[str, Any]):
    """The actor's squashed sample of the ``observations`` rows."""
    def policy(obs, eps):
        mean, std = state["actor"](obs["observations"])
        return squash_sample(mean, std, eps, state["action_scale"], state["action_bias"])[0]

    return policy


def sac_greedy(state: Dict[str, Any], cfg):
    """The greedy action of one observation dict of ``[1, ...]`` arrays."""
    keys = list(cfg.mlp_keys.encoder)

    @torch.no_grad()
    def act(obs):
        x = torch.as_tensor(concat_obs(obs, keys, 1)).to(state["action_scale"].device)
        mean, _ = state["actor"](x)
        return greedy_action(mean, state["action_scale"], state["action_bias"]).cpu().numpy()

    return act


@register_algorithm()
def main(fabric, cfg) -> Dict[str, Any]:
    """The SAC training run. Returns the loop's counters, where its host time
    went, how its steps ran on the card and, with ``env.backend=jax``, the
    engine's bursts and the ring's size."""
    run = open_run(fabric, cfg, "SAC", allow_device_envs=True)
    obs_dim = check_vector_obs(cfg, run.observation_space, "SAC")
    act_dim = run.act_dim
    agent = build_agent_state(obs_dim, act_dim, int(cfg.algo.actor.hidden_size), int(cfg.algo.critic.hidden_size),
                              int(cfg.algo.critic.n), float(cfg.algo.alpha.alpha), torch.Generator().manual_seed(
                                  int(cfg.seed)), device=run.device)
    state = build_optimizers_and_state(cfg, agent, generator=run.generator)
    state["action_scale"] = torch.as_tensor(run.action_scale).to(run.device)
    state["action_bias"] = torch.as_tensor(run.action_bias).to(run.device)
    resumed = read_resume_checkpoint(fabric, cfg)
    if resumed is not None:
        load_agent_state(state, resumed["agent"], resumed["opt_states"], _MODULES + ("target_critics",))
    program = build_train_fn(cfg, act_dim, -float(act_dim), emit_td=needs_td_writeback(cfg))

    def checkpoint_state():
        agent_tree, opt_states = agent_state_dict(state, _MODULES + ("target_critics",))
        return {"agent": agent_tree, "opt_states": opt_states}

    return train_loop(
        fabric, cfg, run, state, resumed,
        obs_rows=vector_rows(cfg),
        stored_keys=("observations",),
        acting_policy=sac_acting_policy(state),
        train_round=sac_train_round(cfg, program, state, run.n_envs),
        loss_names=LOSS_NAMES,
        checkpoint_state=checkpoint_state,
        publish=lambda: {"agent": {"actor": state["actor"].state_dict()}},
        greedy=sac_greedy(state, cfg),
        programs=[program],
    )

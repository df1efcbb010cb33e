"""PPO training (counterpart of ``sheeprl_tpu/algos/ppo/ppo.py``): the
update (:class:`UpdateProgram` over :func:`ppo_loss`), the on-policy loop
PPO, A2C and PPO-recurrent share (:func:`train_loop` over a :class:`PPO`
family, which A2C and PPO-recurrent subclass) and the training run
(:func:`main`, registered as ``ppo``).

Per update, as in the JAX loop: ``rollout_steps`` acting steps of the
``n`` envs into the rollout storage (a truncated env's reward gets
``V(s′)`` of its final observation added, at the acting parameters); GAE
over the rollout (:func:`~sheeprl_tpu_torch.utils.utils.gae`);
the rollout flattened env-major; then ``update_epochs`` passes, each over a
fresh permutation of the ``N`` samples cut to ``N // bs`` minibatches of
``bs`` (the tail dropped), one clipped-surrogate gradient step a minibatch.
The learning rate (``anneal_lr``), the clip and the entropy coefficients
(``anneal_clip_coef``, ``anneal_ent_coef``) decay linearly over the
updates; each lives in a device scalar, so that annealing changes no
captured graph.

On the card every acting step is one CUDA graph replay
(:class:`ActingGraph`: the observation and the pre-drawn noise copied into
static buffers), GAE is one, and every minibatch gradient step is one
(:class:`UpdateProgram`: the flat rollout in static device buffers, the
minibatch's indices a static input cut from a permutation drawn on the
device, the metrics summed on the device); the host synchronises once an
acting step (the env needs the actions) and not inside an update. On the
CPU the same functions run eagerly.

With ``fabric.devices>1`` each rank steps its own ``env.num_envs`` envs
(JAX's global env indices for their seeds) and updates on its own rollout
(or, with ``buffer.share_data``, on its slice of one global permutation of
every rank's), each minibatch's gradients the world's mean
(:class:`UpdateProgram`); ``policy_step`` counts the world's steps.

The checkpoint holds the JAX tree's entries: ``params`` (the agent's
``state_dict``), ``opt_state`` (the optimizer's per-parameter state and
learning rate), ``update``, ``batch_size``, ``last_log`` and
``last_checkpoint``. A run resumes from the port's checkpoints and from
the JAX package's (the flax params and optax state converted,
``convert.convert_ppo``, ``convert.convert_optax_state``).
"""

from __future__ import annotations

import os
import warnings
from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import _graph_counts, give_zero_grads, load_optimizer_state
from sheeprl_tpu_torch.algos.ppo.agent import build_agent, draw_noise, evaluate_actions, greedy_actions, sample_actions
from sheeprl_tpu_torch.algos.ppo.loss import entropy_loss, policy_loss, value_loss
from sheeprl_tpu_torch.algos.ppo.utils import normalize_obs, prepare_obs, test
from sheeprl_tpu_torch.algos.sac.sac import unsupported
from sheeprl_tpu_torch.ckpt import preemption_requested, should_checkpoint, warn_checkpoint_rounding
from sheeprl_tpu_torch.config.instantiate import instantiate
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.vector import make_vector_env
from sheeprl_tpu_torch.evals.builders import actions_dim_of
from sheeprl_tpu_torch.obs.counters import add_rollout_burst, count_h2d
from sheeprl_tpu_torch.obs.dist.comms import all_gather, pmean, pmean_
from sheeprl_tpu_torch.obs.learn import learn_tap, probe_losses, probe_update, tapped
from sheeprl_tpu_torch.obs.perf import PhaseSeconds, log_sps_metrics, register_step_cost
from sheeprl_tpu_torch.obs.prof.capture import profile_tick
from sheeprl_tpu_torch.obs.spans import span
from sheeprl_tpu_torch.replay import make_replay_buffer
from sheeprl_tpu_torch.train.graphs import CapturedStep
from sheeprl_tpu_torch.utils.logger import create_tensorboard_logger
from sheeprl_tpu_torch.utils.metric import MetricAggregator, SumMetric
from sheeprl_tpu_torch.utils.optim import clip_by_global_norm_, set_lr
from sheeprl_tpu_torch.utils.registry import register_algorithm
from sheeprl_tpu_torch.utils.utils import gae, normalize_tensor, polynomial_decay, save_configs

__all__ = [
    "LOSS_NAMES",
    "ActingGraph",
    "GaeStep",
    "PPO",
    "UpdateProgram",
    "build_optimizer",
    "flat_env_major",
    "main",
    "open_run",
    "ppo_loss",
    "train_loop",
]

#: the update's metrics, in the order of its stacked output
LOSS_NAMES = ("Loss/policy_loss", "Loss/value_loss", "Loss/entropy_loss")


# ---------------------------------------------------------------------------
# captured steps
# ---------------------------------------------------------------------------


class ActingGraph:
    """One acting step over static buffers: ``policy(inputs, noise) ->
    tuple of tensors``, replayed from a CUDA graph on the card. Each call
    copies the host ``inputs`` in, draws the noise with ``draw(generator)``
    (or copies the given one) and returns the outputs as numpy arrays."""

    def __init__(self, policy: Callable, example: Mapping[str, np.ndarray],
                 draw: Callable[[Optional[torch.Generator]], List[torch.Tensor]],
                 generator: Optional[torch.Generator], device):
        self.device = torch.device(device)
        self._draw, self._generator = draw, generator
        self.inputs = {k: torch.zeros(np.shape(v), dtype=torch.from_numpy(np.asarray(v)).dtype, device=self.device)
                       for k, v in example.items()}
        self.noise = [torch.zeros_like(t) for t in draw(None)]
        self.step = CapturedStep(torch.no_grad()(lambda: policy(self.inputs, self.noise)), self.device,
                                 name="act")

    def __call__(self, inputs: Mapping[str, np.ndarray], noise: Optional[Sequence[torch.Tensor]] = None):
        for k, v in inputs.items():
            self.inputs[k].copy_(torch.from_numpy(np.ascontiguousarray(v)))
        for dst, src in zip(self.noise, noise if noise is not None else self._draw(self._generator), strict=True):
            dst.copy_(src)
        add_rollout_burst(act_dispatches=1)
        return [o.cpu().numpy() for o in self.step()]


class GaeStep:
    """:func:`~sheeprl_tpu_torch.utils.utils.gae` over static buffers
    (``rewards``, ``values``, ``dones`` ``[T, n, 1]``, ``next_value``
    ``[n, 1]``), one CUDA graph replay on the card. Returns ``(returns,
    advantages)``, the graph's outputs (the next call overwrites them)."""

    def __init__(self, gamma: float, gae_lambda: float, device):
        self.gamma, self.gae_lambda = float(gamma), float(gae_lambda)
        self.device = torch.device(device)
        self.static: Optional[Dict[str, torch.Tensor]] = None
        self.step: Optional[CapturedStep] = None

    def __call__(self, rewards, values, dones, next_value):
        given = {"rewards": rewards, "values": values, "dones": dones, "next_value": next_value}
        given = {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v).float()
                 for k, v in given.items()}
        if self.static is None:
            self.static = {k: torch.zeros(v.shape, dtype=torch.float32, device=self.device) for k, v in given.items()}
            s = self.static
            self.step = CapturedStep(lambda: gae(s["rewards"], s["values"], s["dones"], s["next_value"], self.gamma,
                                                 self.gae_lambda), self.device, name="gae")
        for k, v in given.items():
            self.static[k].copy_(v)
        return self.step()


class UpdateProgram:
    """The update: ``epochs`` passes over the ``n_samples`` rows of ``data``,
    each in ``n_samples // batch_size`` minibatches of a permutation, one
    gradient step a minibatch (``loss_fn(agent, batch, scalars) -> (loss,
    metrics)``, its backward, the global-norm clip at ``max_grad_norm`` when
    it is > 0, the optimizer's step). ``select(data, idx)`` cuts a minibatch
    (rows of the flat rollout, or sequences). ``scalars`` (the clip and
    entropy coefficients) are a device vector. The data live in static
    device buffers; on the card the step is replayed from one CUDA graph.

    ``update(data, scalars, perms=None)`` loads the data and runs the
    update; ``perms`` (``[epochs, n_rows]`` int64) replaces the
    permutations drawn from ``generator`` (the JAX update's own, in the
    parity tests); ``eager`` runs every step eagerly (the graph's yardstick
    on the card). Returns the metrics' mean over the update's steps, a
    device tensor. Built with the learn probes on (``obs.learn``), each
    step also probes the raw gradients, the parameters and the applied
    update under ``agent``, and an update hands its steps' probes to the
    sentinel in one pull.

    In a data-parallel world each minibatch's gradients are the world's
    mean (``obs.dist.comms.pmean_``) before the clip, and the update's
    metrics are the world's mean. ``share_data`` is the JAX update's
    ``buffer.share_data``: the data hold every rank's rollout, rank after
    rank (``n_rows = world·n_samples``), every rank draws the same
    permutation of all of them from ``generator`` (seeded alike on every
    rank) and trains on its own slice of it, ``[rank·n_samples,
    (rank+1)·n_samples)``; without it each rank permutes its own
    ``n_samples`` rows."""

    def __init__(self, loss_fn, select, agent: torch.nn.Module, optimizer: torch.optim.Optimizer, *,
                 max_grad_norm: float, epochs: int, n_samples: int, batch_size: int, n_metrics: int,
                 n_scalars: int, generator: Optional[torch.Generator], device, share_data: bool = False,
                 rank: int = 0, world_size: int = 1):
        self._loss_fn, self._select = loss_fn, select
        self.agent, self.optimizer = agent, optimizer
        self.max_grad_norm = float(max_grad_norm or 0.0)
        self.epochs, self.n_samples = int(epochs), int(n_samples)
        self.batch_size = min(int(batch_size), self.n_samples)
        self.n_minibatches = self.n_samples // self.batch_size
        self.share_data, self.rank = bool(share_data), int(rank)
        self.n_rows = self.n_samples * (int(world_size) if self.share_data else 1)
        self.generator = generator
        self.device = torch.device(device)
        self.data: Optional[Dict[str, torch.Tensor]] = None
        self.idx = torch.zeros(self.batch_size, dtype=torch.int64, device=self.device)
        self.scalars = torch.zeros(int(n_scalars), dtype=torch.float32, device=self.device)
        self.acc = torch.zeros(int(n_metrics), dtype=torch.float32, device=self.device)
        self._params = [p for p in agent.parameters()]
        give_zero_grads([agent])
        self.learn_tap = learn_tap()
        self._probed_step = tapped(self._step, self.learn_tap)
        self.step = CapturedStep(self._probed_step, self.device, train=True)

    def _step(self) -> torch.Tensor:
        grads = [p.grad for p in self._params]
        torch._foreach_zero_(grads)
        loss, metrics = self._loss_fn(self.agent, self._select(self.data, self.idx), self.scalars)
        loss.backward()
        pmean_(grads)
        probed = probe_update("agent", grads, self._params, self.optimizer, self.max_grad_norm or None)
        if self.max_grad_norm > 0:
            clip_by_global_norm_(grads, self.max_grad_norm, norm=probed.grad_norm)
        self.optimizer.step()
        probed()
        probe_losses(metrics)
        self.acc.add_(metrics.detach())
        return self.acc

    def load(self, data: Mapping[str, Any]) -> None:
        """Copy ``data`` (numpy arrays or tensors) into the static buffers."""
        tensors = {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
                   for k, v in data.items()}
        if self.data is None:
            self.data = {k: torch.zeros(v.shape, dtype=v.dtype, device=self.device) for k, v in tensors.items()}
        if self.data.keys() != tensors.keys() or any(self.data[k].shape != v.shape for k, v in tensors.items()):
            raise ValueError("an UpdateProgram updates on one data layout")
        with span("Time/stage_h2d_time", phase="stage_h2d"):
            for k, v in tensors.items():
                self.data[k].copy_(v, non_blocking=True)
        count_h2d(tensors)

    def update(self, data: Mapping[str, Any], scalars: Sequence[float], perms: Optional[Sequence[Any]] = None,
               eager: bool = False) -> torch.Tensor:
        self.load(data)
        self.scalars.copy_(torch.as_tensor(np.asarray(scalars, np.float32)))
        self.acc.zero_()
        for e in range(self.epochs):
            if perms is not None:
                perm = torch.as_tensor(np.asarray(perms[e]), dtype=torch.int64).to(self.device)
            else:
                perm = torch.randperm(self.n_rows, generator=self.generator, device=self.device)
            if self.share_data:
                perm = perm[self.rank * self.n_samples:(self.rank + 1) * self.n_samples]
            for m in range(self.n_minibatches):
                self.idx.copy_(perm[m * self.batch_size:(m + 1) * self.batch_size])
                self._probed_step() if eager else self.step()
                if self.learn_tap is not None:
                    self.learn_tap.collect()
        if self.learn_tap is not None:
            self.learn_tap.flush()
        return pmean(self.acc / float(self.epochs * self.n_minibatches))


def gather_rows(data: Mapping[str, Any], device) -> Dict[str, torch.Tensor]:
    """Every rank's rows of ``data`` (``[n, ...]`` arrays or tensors),
    concatenated rank after rank on ``device``: the JAX update's replicated
    rollout under ``buffer.share_data``."""
    out = {}
    for k, v in data.items():
        t = (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))).to(device)
        out[k] = all_gather(t).reshape((-1,) + tuple(t.shape[1:]))
    return out


def select_rows(data: Mapping[str, torch.Tensor], idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {k: v.index_select(0, idx) for k, v in data.items()}


def ppo_loss(cfg, cnn_keys: Sequence[str], obs_keys: Sequence[str], actions_dim: Sequence[int],
             is_continuous: bool, forward: Optional[Callable] = None):
    """PPO's minibatch loss at ``cfg``: ``(loss, [policy, value, entropy])``
    with ``scalars = [clip_coef, ent_coef]``; the advantages normalized per
    minibatch with ``normalize_advantages`` (population std).
    ``forward(agent, obs, batch) -> (pre_dist, values)`` runs the agent
    (PPO's ``agent(obs)`` by default; PPO-recurrent's over the sequences)."""
    reduction, vf_coef = cfg.algo.loss_reduction, float(cfg.algo.vf_coef)
    clip_vloss, norm_adv = bool(cfg.algo.clip_vloss), bool(cfg.algo.normalize_advantages)
    if forward is None:
        forward = lambda agent, obs, batch: agent(obs)  # noqa: E731

    def loss_fn(agent, batch, scalars):
        clip_coef, ent_coef = scalars[0], scalars[1]
        pre_dist, new_values = forward(agent, normalize_obs(batch, cnn_keys, obs_keys), batch)
        adv = normalize_tensor(batch["advantages"]) if norm_adv else batch["advantages"]
        new_logprobs, entropy = evaluate_actions(pre_dist, batch["actions"], actions_dim, is_continuous)
        pg = policy_loss(new_logprobs, batch["logprobs"], adv, clip_coef, reduction)
        v = value_loss(new_values, batch["values"], batch["returns"], clip_coef, clip_vloss, reduction)
        ent = entropy_loss(entropy, reduction)
        return pg + vf_coef * v + ent_coef * ent, torch.stack([pg, v, ent])

    return loss_fn


def build_optimizer(cfg, agent: torch.nn.Module) -> torch.optim.Optimizer:
    """``cfg.algo.optimizer`` (the port's ``Adam``, ``AdamW`` or ``SGD``) over the agent."""
    return instantiate(cfg.algo.optimizer, agent.parameters())


def flat_env_major(x) -> Any:
    """``[T, n, ...]`` → ``[n·T, ...]``, each env's steps contiguous (the
    JAX ``flat``): numpy or torch."""
    if isinstance(x, torch.Tensor):
        return x.transpose(0, 1).reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))
    x = np.asarray(x)
    return np.swapaxes(x, 0, 1).reshape((x.shape[0] * x.shape[1],) + x.shape[2:])


# ---------------------------------------------------------------------------
# the on-policy loop
# ---------------------------------------------------------------------------


def open_run(fabric, cfg, family: str) -> SimpleNamespace:
    """The run's seeded generator, logger, saved config and vector env;
    checks the observation space (a Dict with at least one encoder key)."""
    unsupported(cfg, family)
    generator, _ = fabric.seed_everything(cfg.seed)
    logger, log_dir = create_tensorboard_logger(cfg)
    fabric.logger = logger
    if logger is not None:
        logger.log_hyperparams(cfg.as_dict() if hasattr(cfg, "as_dict") else dict(cfg))
    if fabric.is_global_zero:
        save_configs(cfg, log_dir)
    envs = make_vector_env(cfg, fabric, log_dir)
    observation_space = envs.single_observation_space
    if not isinstance(observation_space, spaces.Dict):
        raise RuntimeError(f"Unexpected observation type, should be of type Dict, got: {observation_space}")
    if len(cfg.cnn_keys.encoder) + len(cfg.mlp_keys.encoder) == 0:
        raise RuntimeError(
            "You should specify at least one CNN keys or MLP keys from the cli: "
            "`cnn_keys.encoder=[rgb]` or `mlp_keys.encoder=[state]`"
        )
    if cfg.metric.log_level > 0:
        fabric.print("Encoder CNN keys:", cfg.cnn_keys.encoder)
        fabric.print("Encoder MLP keys:", cfg.mlp_keys.encoder)
    actions_dim, is_continuous = actions_dim_of(envs.single_action_space)
    cnn_keys, mlp_keys = list(cfg.cnn_keys.encoder), list(cfg.mlp_keys.encoder)
    return SimpleNamespace(
        generator=generator, device=fabric.device, logger=logger, log_dir=log_dir, envs=envs,
        n_envs=int(cfg.env.num_envs), observation_space=observation_space,
        action_space=envs.single_action_space, actions_dim=actions_dim, is_continuous=is_continuous,
        cnn_keys=cnn_keys, mlp_keys=mlp_keys, obs_keys=mlp_keys + cnn_keys,
    )


class PPO:
    """The ``ppo`` family's hooks into :func:`train_loop` (A2C and
    PPO-recurrent subclass it): the agent and its optimizer, the acting
    step, the rows it stores, the value of a truncated env's final
    observation, the update's data and scalars, the checkpoint's entries and
    the greedy policy."""

    loss_names: Sequence[str] = LOSS_NAMES
    #: the checkpoint's entry that sets the per-rank batch on resume (``batch_size`` or ``num_batches``)
    batch_entry = "batch_size"
    #: the extra per-step rows the rollout stores
    stored: Sequence[str] = ("logprobs",)
    #: the learning rate and the clip and entropy coefficients anneal (and are logged); A2C's do not exist
    anneals = True

    def __init__(self, fabric, cfg, run: SimpleNamespace):
        self.fabric, self.cfg, self.run = fabric, cfg, run
        self.device = run.device
        self.agent = self.build_agent(torch.Generator().manual_seed(int(cfg.seed)))
        self.optimizer = build_optimizer(cfg, self.agent)
        self.resumed = load_resume(fabric, cfg, self)
        fabric.sync_modules(self.agent)  # rank 0's starting weights on every rank (a no-op outside a world)
        self.n_steps = int(cfg.algo.rollout_steps)
        self.program = self.make_program(cfg, self.agent, self.optimizer, run, self.samples(cfg), self.device)
        self.acting = ActingGraph(self.acting_policy, self.acting_inputs(self.initial_obs()), self.noise_for_acting,
                                  run.generator, self.device)

    # -- construction ---------------------------------------------------------

    def build_agent(self, generator: torch.Generator) -> torch.nn.Module:
        r = self.run
        return build_agent(self.cfg, r.actions_dim, r.is_continuous, r.cnn_keys, r.mlp_keys, r.observation_space,
                           generator, device=self.device)

    @staticmethod
    def samples(cfg) -> int:
        """The rows an update takes: every step of every env of the rollout."""
        return int(cfg.algo.rollout_steps) * int(cfg.env.num_envs)

    @classmethod
    def make_program(cls, cfg, agent, optimizer, run, n_samples: int, device) -> UpdateProgram:
        """The update over ``n_samples`` rows; ``run`` names the spaces and
        keys (``actions_dim``, ``is_continuous``, ``cnn_keys``, ``obs_keys``)
        and the permutations' ``generator``. In a data-parallel world with
        ``buffer.share_data`` the permutations come from a generator seeded
        with the run's seed on every rank (one global permutation)."""
        from sheeprl_tpu_torch.parallel import current_world

        world = current_world()
        share = world is not None and bool(cfg.buffer.get("share_data", False))
        generator = torch.Generator(device=device).manual_seed(int(cfg.seed)) if share else run.generator
        bs = min(int(cfg.per_rank_batch_size), n_samples)
        if n_samples % bs != 0:
            warnings.warn(
                f"per_rank_batch_size ({bs}) does not divide the per-device sample count ({n_samples}); each epoch "
                f"drops the {n_samples % bs} samples at the tail of its shuffle (static shapes, as in the JAX package)"
            )
        return UpdateProgram(ppo_loss(cfg, run.cnn_keys, run.obs_keys, run.actions_dim, run.is_continuous),
                             select_rows, agent, optimizer, max_grad_norm=float(cfg.algo.max_grad_norm or 0.0),
                             epochs=int(cfg.algo.update_epochs), n_samples=n_samples, batch_size=bs,
                             n_metrics=len(cls.loss_names), n_scalars=2, generator=generator, device=device,
                             share_data=share, rank=0 if world is None else world.global_rank,
                             world_size=1 if world is None else world.world_size)

    def initial_obs(self) -> Dict[str, np.ndarray]:
        r = self.run
        return {k: np.zeros((r.n_envs,) + prepared_shape(r.observation_space[k].shape, k in r.cnn_keys),
                            r.observation_space[k].dtype if k in r.cnn_keys else np.float32) for k in r.obs_keys}

    # -- acting ---------------------------------------------------------------

    def noise_for_acting(self, generator) -> List[torch.Tensor]:
        return draw_noise(self.run.actions_dim, self.run.is_continuous, (self.run.n_envs,), generator, self.device)

    def acting_inputs(self, obs: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return {k: obs[k] for k in self.run.obs_keys}

    def acting_policy(self, inputs, noise):
        r = self.run
        pre_dist, values = self.agent(normalize_obs(inputs, r.cnn_keys, r.obs_keys))
        actions, real, logprob = sample_actions(pre_dist, r.is_continuous, noise)
        return actions, real, logprob, values

    def act(self, obs: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
        actions, real, logprob, values = self.acting(self.acting_inputs(obs))
        return {"actions": actions, "real": real, "logprobs": logprob, "values": values}

    def rows(self, out: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """The family's extra rollout rows of one step, ``[n, ...]``."""
        return {k: out[k] for k in self.stored}

    def after_step(self, out: Mapping[str, np.ndarray], dones: np.ndarray) -> None:
        """The family's state after an env step (PPO has none)."""

    @torch.no_grad()
    def value(self, obs: Mapping[str, np.ndarray], out: Optional[Mapping[str, np.ndarray]] = None,
              env_ids: Optional[np.ndarray] = None) -> np.ndarray:
        """``V`` of host observations ``[m, ...]``, at the agent's parameters
        (``out`` and ``env_ids``: the acting step whose envs these are, for a
        recurrent family's state)."""
        r = self.run
        norm = normalize_obs({k: torch.from_numpy(np.ascontiguousarray(obs[k])).to(self.device) for k in r.obs_keys},
                             r.cnn_keys, r.obs_keys)
        return self.agent.get_value(norm).cpu().numpy()

    def next_value(self, obs: Mapping[str, np.ndarray]) -> torch.Tensor:
        """``V`` of the observations after the rollout (GAE's bootstrap)."""
        return torch.from_numpy(self.value(obs))

    def rollout_start(self) -> None:
        """Before an update's acting steps."""

    # -- the update -----------------------------------------------------------

    def update_data(self, rb, returns: torch.Tensor, advantages: torch.Tensor) -> Dict[str, Any]:
        """The rollout flattened env-major: the observations, actions, stored
        rows, returns and advantages."""
        data = {k: flat_env_major(rb[k]) for k in (*self.run.obs_keys, "actions", "values", *self.stored)}
        data["returns"] = flat_env_major(returns)
        data["advantages"] = flat_env_major(advantages)
        return data

    def scalars(self) -> List[float]:
        return [float(self.cfg.algo.clip_coef), float(self.cfg.algo.ent_coef)]

    def checkpoint_entries(self) -> Dict[str, Any]:
        return {
            "params": {k: v.detach() for k, v in self.agent.state_dict().items()},
            "opt_state": optimizer_entry(self.optimizer),
            "batch_size": int(self.cfg.per_rank_batch_size) * self.fabric.world_size,
        }

    def greedy(self) -> Callable[[Mapping[str, np.ndarray]], np.ndarray]:
        r = self.run

        @torch.no_grad()
        def act(obs):
            prepared = prepare_obs(obs, r.cnn_keys, 1)
            norm = normalize_obs({k: torch.from_numpy(prepared[k]).to(self.device) for k in r.obs_keys}, r.cnn_keys,
                                 r.obs_keys)
            return greedy_actions(self.agent.pre_dist(norm), r.is_continuous).cpu().numpy()

        return act


def prepared_shape(shape: Sequence[int], is_cnn: bool) -> tuple:
    """An observation's shape after :func:`prepare_obs` (a frame stack folded
    into the channels; a vector flattened)."""
    shape = tuple(int(s) for s in shape)
    if is_cnn:
        return (int(np.prod(shape[:-2])),) + shape[-2:]
    return (int(np.prod(shape)),)


def optimizer_entry(optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """The checkpoint's ``opt_state``: the per-parameter state and the learning rate."""
    return {"state": optimizer.state_dict()["state"], "lr": float(optimizer.param_groups[0]["lr"])}


def load_resume(fabric, cfg, family: PPO) -> Optional[Dict[str, Any]]:
    """``checkpoint.resume_from``'s state loaded into the family's agent and
    optimizer (None without one): the port's checkpoint as it is, the JAX
    package's converted (``convert.convert_<algo>``, ``convert_optax_state``);
    the per-rank batch entry set from it."""
    if not cfg.checkpoint.resume_from:
        return None
    from sheeprl_tpu_torch import convert
    from sheeprl_tpu_torch.ckpt import read_manifest

    framework = read_manifest(cfg.checkpoint.resume_from).get("framework")
    state = fabric.load(cfg.checkpoint.resume_from)
    names = [n for n, _ in family.agent.named_parameters()]
    if framework == "torch":
        params, opt_state = state["params"], state["opt_state"]
    else:
        to_port = convert.onpolicy_converter(str(cfg.algo.name))
        params = to_port(state["params"])
        opt_state = convert.convert_optax_state(state["opt_state"], to_port, names)
    family.agent.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in params.items()})
    load_optimizer_state(family.optimizer, opt_state)
    set_lr(family.optimizer, float(np.asarray(opt_state["lr"])))
    if family.batch_entry == "batch_size":
        cfg.per_rank_batch_size = int(np.asarray(state["batch_size"])) // fabric.world_size
    else:
        cfg.per_rank_num_batches = int(np.asarray(state["num_batches"]))
    return state


def train_loop(fabric, cfg, run: SimpleNamespace, family: PPO) -> Dict[str, Any]:
    """The on-policy loop (the JAX ``main``'s, for PPO, A2C and
    PPO-recurrent). Returns the loop's counters, the episodes' returns,
    where its host time went and how its steps ran on the card."""
    world_size = fabric.world_size
    device, logger, log_dir, n_envs = run.device, run.logger, run.log_dir, run.n_envs
    envs, obs_keys, cnn_keys = run.envs, run.obs_keys, run.cnn_keys
    aggregator = None
    if not MetricAggregator.disabled:
        aggregator = instantiate(cfg.metric.aggregator)
    n_steps = family.n_steps
    if int(cfg.buffer.size) < n_steps:
        raise ValueError(
            f"The size of the buffer ({cfg.buffer.size}) cannot be lower than the rollout steps ({n_steps})"
        )
    rb = make_replay_buffer(cfg, fabric, log_dir, n_envs=n_envs, obs_keys=tuple(obs_keys), size=int(cfg.buffer.size),
                            min_size=n_steps, sampled=False)
    gae_step = GaeStep(float(cfg.algo.gamma), float(cfg.algo.gae_lambda), device)

    resumed = family.resumed
    start_step = int(np.asarray(resumed["update"])) // world_size if resumed is not None else 1
    policy_step = (int(np.asarray(resumed["update"])) * int(cfg.env.num_envs) * n_steps
                   if resumed is not None else 0)
    last_log = int(np.asarray(resumed["last_log"])) if resumed is not None else 0
    last_checkpoint = int(np.asarray(resumed["last_checkpoint"])) if resumed is not None else 0
    policy_steps_per_update = int(n_envs * n_steps) * world_size
    num_updates = int(cfg.total_steps) // policy_steps_per_update if not cfg.dry_run else 1
    if cfg.metric.log_level > 0 and cfg.metric.log_every % policy_steps_per_update != 0:
        warnings.warn(
            f"The metric.log_every parameter ({cfg.metric.log_every}) is not a multiple of the "
            f"policy_steps_per_update value ({policy_steps_per_update}), so the metrics will be logged at the "
            "nearest greater multiple of the policy_steps_per_update value."
        )
    warn_checkpoint_rounding(cfg, policy_steps_per_update)
    initial_ent_coef, initial_clip_coef = float(cfg.algo.get("ent_coef", 0.0)), float(cfg.algo.get("clip_coef", 0.0))

    seconds = PhaseSeconds("env", "act", "gae_and_stage", "train", "checkpoint", "test")
    counters = {"updates": 0, "acting_steps": 0, "gradient_steps": 0}
    episode_returns: List[float] = []
    loss_sum, loss_count = None, 0
    train_step = last_train = 0
    checkpoint_path = None
    # env i of rank r is JAX's env r·n_envs + i: its seed is the run's seed plus that index
    obs = prepare_obs(envs.reset(seed=cfg.seed + fabric.global_rank * n_envs)[0], cnn_keys, n_envs)

    for update in range(start_step, num_updates + 1):
        lr = float(cfg.algo.optimizer.lr)
        if family.anneals and cfg.algo.get("anneal_lr", False):
            lr = polynomial_decay(update - 1, initial=float(cfg.algo.optimizer.lr), final=0.0,
                                  max_decay_steps=num_updates, power=1.0)
            set_lr(family.optimizer, lr)
        family.rollout_start()
        for _ in range(n_steps):
            with span("Time/rollout_time", SumMetric(), phase="rollout"):
                with seconds.phase("act"):
                    out = family.act(obs)
                policy_step += n_envs * world_size
                with seconds.phase("env"):
                    with span("Time/env_interaction_time", SumMetric(), phase="env"):
                        next_o, rewards, terminated, truncated, info = envs.step(
                            np.asarray(out["real"]).reshape(envs.action_space.shape))
                    rewards = np.asarray(rewards, np.float32).reshape(n_envs).copy()
                    truncated_envs = np.nonzero(truncated)[0]
                    if len(truncated_envs) > 0:
                        # bootstrap V(s') of the final observation into the reward on truncation
                        final = info["final_obs"]
                        t_obs = prepare_obs(
                            {k: np.stack([np.asarray(final[e][k]) for e in truncated_envs]) for k in obs_keys},
                            cnn_keys, len(truncated_envs))
                        rewards[truncated_envs] += family.value(t_obs, out, truncated_envs).reshape(-1)
                    dones = np.logical_or(terminated, truncated).astype(np.float32)
                    step_data = {k: np.asarray(obs[k])[None] for k in obs_keys}
                    step_data["dones"] = dones.reshape(1, n_envs, 1)
                    step_data["values"] = np.asarray(out["values"], np.float32).reshape(1, n_envs, 1)
                    step_data["actions"] = np.asarray(out["actions"], np.float32).reshape(1, n_envs, -1)
                    step_data["rewards"] = rewards.reshape(1, n_envs, 1)
                    for k, v in family.rows(out).items():
                        step_data[k] = np.asarray(v)[None]
                    rb.add(step_data)
                    family.after_step(out, dones)
                    obs = prepare_obs(next_o, cnn_keys, n_envs)
                    if "final_info" in info:
                        fi = info["final_info"]
                        if isinstance(fi, dict) and "episode" in fi:
                            for i in np.nonzero(np.asarray(fi.get("_episode", []), dtype=bool))[0]:
                                ep_rew, ep_len = float(fi["episode"]["r"][i]), float(fi["episode"]["l"][i])
                                episode_returns.append(ep_rew)
                                if cfg.metric.log_level > 0:
                                    if aggregator and not aggregator.disabled:
                                        aggregator.update("Rewards/rew_avg", ep_rew)
                                        aggregator.update("Game/ep_len_avg", ep_len)
                                    fabric.print(f"Rank-0: policy_step={policy_step}, reward_env_{i}={ep_rew}")
            counters["acting_steps"] += 1

        with seconds.phase("gae_and_stage"):
            next_values = family.next_value(obs)
            returns, advantages = gae_step(rb["rewards"], rb["values"], rb["dones"], next_values)
            data = family.update_data(rb, returns, advantages)
            if family.program.share_data:
                data = gather_rows(data, device)
        with seconds.phase("train"), span(
            "Time/train_time", SumMetric(sync_on_compute=cfg.metric.sync_on_compute), phase="train"
        ):
            metrics = family.program.update(data, family.scalars())
        minibatch_steps = family.program.epochs * family.program.n_minibatches
        register_step_cost(family.program.step, dispatches_per_step=minibatch_steps, world_size=world_size)
        counters["gradient_steps"] += minibatch_steps
        counters["updates"] += 1
        loss_sum = metrics.clone() if loss_sum is None else loss_sum.add_(metrics)
        loss_count += 1
        train_step += world_size

        if cfg.metric.log_level > 0 and logger is not None and family.anneals:
            logger.log_metrics({"Info/learning_rate": lr}, policy_step)
            logger.log_metrics({"Info/clip_coef": float(cfg.algo.clip_coef)}, policy_step)
            logger.log_metrics({"Info/ent_coef": float(cfg.algo.ent_coef)}, policy_step)

        if cfg.metric.log_level > 0 and (policy_step - last_log >= cfg.metric.log_every or update == num_updates):
            if aggregator and not aggregator.disabled:
                for name, value in zip(family.loss_names, (loss_sum / loss_count).tolist()):
                    if name in aggregator:
                        aggregator.update(name, value)
                aggregator.sync(fabric)  # every rank's episodes, as the JAX run's one process saw them
                if logger is not None:
                    logger.log_metrics(aggregator.compute(), policy_step)
                aggregator.reset()
            loss_sum, loss_count = None, 0
            log_sps_metrics(logger, policy_step=policy_step, last_log=last_log, train_step=train_step,
                            last_train=last_train, world_size=world_size, action_repeat=cfg.env.action_repeat)
            profile_tick(policy_step=policy_step, world_size=world_size)
            last_log, last_train = policy_step, train_step

        if family.anneals and cfg.algo.get("anneal_clip_coef", False):
            cfg.algo.clip_coef = polynomial_decay(update, initial=initial_clip_coef, final=0.0,
                                                  max_decay_steps=num_updates, power=1.0)
        if family.anneals and cfg.algo.get("anneal_ent_coef", False):
            cfg.algo.ent_coef = polynomial_decay(update, initial=initial_ent_coef, final=0.0,
                                                 max_decay_steps=num_updates, power=1.0)

        if should_checkpoint(cfg, policy_step, last_checkpoint, update, num_updates):
            with seconds.phase("checkpoint"), span("Time/checkpoint_time", phase="checkpoint"):
                last_checkpoint = policy_step
                ckpt_state = {**family.checkpoint_entries(), "update": update * world_size, "last_log": last_log,
                              "last_checkpoint": last_checkpoint}
                checkpoint_path = os.path.join(log_dir, "checkpoint", f"ckpt_{policy_step}_{fabric.global_rank}")
                fabric.call("on_checkpoint_coupled", ckpt_path=checkpoint_path, state=ckpt_state,
                            replay_buffer=rb if cfg.buffer.get("checkpoint", False) else None)
            if preemption_requested():
                break

    envs.close()
    test_reward, test_steps = None, 0
    if fabric.is_global_zero and cfg.algo.get("run_test", True) and not preemption_requested():
        with seconds.phase("test"):
            test_reward, test_steps = test(family.greedy(), fabric, cfg, log_dir)
    if logger is not None:
        logger.close()
    return {
        **counters,
        "policy_steps": policy_step,
        "episode_returns": episode_returns,
        "test_steps": test_steps,
        "test_reward": test_reward,
        "log_dir": log_dir,
        "event_file": None if logger is None else logger.path,
        "checkpoint": checkpoint_path,
        "seconds": seconds,
        "graphs": {"train": _graph_counts([family.program.step]), "act": _graph_counts([family.acting.step]),
                   "gae": _graph_counts([] if gae_step.step is None else [gae_step.step])},
    }


@register_algorithm()
def main(fabric, cfg) -> Dict[str, Any]:
    """The PPO training run (see :func:`train_loop` for its result)."""
    if "minedojo" in str(cfg.env.wrapper.get("_target_", "") or "").lower():
        raise ValueError(
            "MineDojo is not currently supported by PPO agent, since it does not take into consideration the action "
            "masks provided by the environment. As an alternative you can use one of the Dreamers' agents."
        )
    run = open_run(fabric, cfg, "PPO")
    return train_loop(fabric, cfg, run, PPO(fabric, cfg, run))

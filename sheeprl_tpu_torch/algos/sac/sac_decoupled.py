"""SAC, decoupled: the learner on the actor–learner plane (counterpart of
``sheeprl_tpu/algos/sac/sac_decoupled.py``), registered as
``sac_decoupled``.

Collection runs in :func:`~sheeprl_tpu_torch.algos.sac.player.run_player`
on the plane ``plane.num_players`` picks: one player thread (0) or N player
processes, each with its slice of the envs through the worker pool, acting
on the CPU. The learner receives each burst's slabs, adds them to the
replay (``replay.shards=N`` gives each player its own shard), runs SAC's
gradient steps as the coupled loop does (:class:`~sheeprl_tpu_torch.algos.
sac.sac.StepProgram`, :func:`~sheeprl_tpu_torch.algos.sac.sac.sac_train_round`,
the TD priorities written back under ``replay.strategy=td_priority``) and
publishes the actor as the protocol's next version. The learner trains
update ``u − 1`` while the players collect ``u``; at ``plane.max_policy_lag=0``
a seeded 1-player process run is bitwise the thread run.

The checkpoint holds the coupled SAC's entries; a run resumes from the
port's checkpoints and from the JAX package's (converted). Like the JAX
entrypoint it refuses ``fabric.devices=1`` (``cli.check_configs``).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import _graph_counts
from sheeprl_tpu_torch.algos.sac.agent import action_bounds, build_agent_state
from sheeprl_tpu_torch.algos.sac.player import run_player, sac_slab_example
from sheeprl_tpu_torch.algos.sac.sac import (
    LOSS_NAMES,
    agent_state_dict,
    build_optimizers_and_state,
    build_train_fn,
    check_vector_obs,
    load_agent_state,
    needs_td_writeback,
    sac_greedy,
    sac_train_round,
    unsupported,
)
from sheeprl_tpu_torch.algos.sac.utils import test
from sheeprl_tpu_torch.ckpt import preemption_requested, should_checkpoint, warn_checkpoint_rounding
from sheeprl_tpu_torch.config.instantiate import instantiate
from sheeprl_tpu_torch.data.staging import make_replay_staging
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.vector import make_eval_env
from sheeprl_tpu_torch.obs.perf import PhaseSeconds, log_sps_metrics, register_step_cost
from sheeprl_tpu_torch.obs.prof.capture import profile_tick
from sheeprl_tpu_torch.obs.spans import span
from sheeprl_tpu_torch.plane import SlabSpec, build_plane, burst_plan, plane_env_split, version_after
from sheeprl_tpu_torch.replay import ReplayPlane, make_replay_buffer, replay_config
from sheeprl_tpu_torch.utils.logger import create_tensorboard_logger
from sheeprl_tpu_torch.utils.metric import MetricAggregator, SumMetric
from sheeprl_tpu_torch.utils.registry import register_algorithm
from sheeprl_tpu_torch.utils.utils import save_configs

__all__ = ["add_player_seconds", "host_params", "learner_result", "main", "probe_spaces", "read_sac_resume"]

#: the players' host seconds by phase, summed over the players: their env steps, acting, waits for a policy
#: version and for a slab credit
PLAYER_PHASES = ("player_env", "player_act", "player_policy_wait", "player_slab_wait")

_MODULES = ("actor", "critics", "target_critics")


def host_params(module: torch.nn.Module) -> Dict[str, np.ndarray]:
    """A module's ``state_dict`` as host arrays the learner no longer
    writes: a published version."""
    return {k: np.array(v.detach().cpu().numpy(), copy=True) for k, v in module.state_dict().items()}


def probe_spaces(cfg):
    """``(observation_space, action_space)`` of one env built here (the
    learner steps no env; the players agree on these spaces)."""
    probe = make_eval_env(cfg, None, prefix="train")
    try:
        return probe.observation_space, probe.action_space
    finally:
        probe.close()


def read_sac_resume(fabric, cfg, state: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """``checkpoint.resume_from``'s state loaded into ``state`` (None
    without one): the port's checkpoint as it is, the JAX package's
    converted (``convert.convert_sac``, ``convert_optax_state``); the
    per-rank batch set from it."""
    if not cfg.checkpoint.resume_from:
        return None
    from sheeprl_tpu_torch import convert
    from sheeprl_tpu_torch.ckpt import read_manifest

    framework = read_manifest(cfg.checkpoint.resume_from).get("framework")
    resumed = fabric.load(cfg.checkpoint.resume_from)
    if framework == "torch":
        agent, opt_states = resumed["agent"], resumed["opt_states"]
    else:
        agent, _ = convert.convert_sac(resumed["agent"], training=True)

        def names(module):
            return [n for n, _ in module.named_parameters()]

        saved = resumed["opt_states"]
        opt_states = {
            "actor": convert.convert_optax_state(saved["actor"], convert.convert_sac_actor, names(state["actor"])),
            "qf": convert.convert_optax_state(saved["qf"], convert.convert_critic_ensemble, names(state["critics"])),
            "alpha": convert.convert_optax_state(
                saved["alpha"], lambda t: {"log_alpha": torch.as_tensor(np.asarray(t, np.float32)).reshape(1)},
                ["log_alpha"]),
        }
    load_agent_state(state, agent, opt_states, _MODULES)
    cfg.per_rank_batch_size = int(np.asarray(resumed["batch_size"])) // fabric.world_size
    return resumed


def add_player_seconds(seconds: Dict[str, float], handles) -> None:
    """Add the received slabs' player seconds by phase to the learner's ``seconds``."""
    for h in handles:
        for phase, s in h.seconds.items():
            seconds[f"player_{phase}"] = seconds.get(f"player_{phase}", 0.0) + s


def learner_result(plane, num_players: int, counters: Dict[str, int], seconds: Dict[str, float],
                   **extra: Any) -> Dict[str, Any]:
    """The decoupled learners' result: their counters, host seconds by
    phase, and the plane's players, slabs, restarts, last published version
    and (process players) each player's report at its exit and, with the
    telemetry on, the watchdog beats each one forwarded."""
    return {**counters, **extra, "seconds": seconds,
            "plane": {"players": num_players, "slabs": plane.slabs, "player_restarts": plane.player_restarts,
                      "policy_version": plane.published_version, "exits": dict(getattr(plane, "exits", {})),
                      "watchdog_beats": dict(getattr(plane, "watchdog_beats", {}))}}


@register_algorithm(decoupled=True)
def main(fabric, cfg) -> Dict[str, Any]:
    """The decoupled SAC learner. Returns the coupled loop's counters and,
    by phase, its host seconds (``plane_wait``: waiting for the players'
    slabs) and the players' (``PLAYER_PHASES``, summed over the players)."""
    unsupported(cfg, "SAC")
    generator, _ = fabric.seed_everything(cfg.seed)
    logger, log_dir = create_tensorboard_logger(cfg)
    fabric.logger = logger
    if logger is not None:
        logger.log_hyperparams(cfg.as_dict() if hasattr(cfg, "as_dict") else dict(cfg))
    if fabric.is_global_zero:
        save_configs(cfg, log_dir)
    observation_space, action_space = probe_spaces(cfg)
    if not isinstance(action_space, spaces.Box):
        raise ValueError("Only continuous action space is supported for the SAC agent")
    if not isinstance(observation_space, spaces.Dict):
        raise RuntimeError(f"Unexpected observation type, should be of type Dict, got: {observation_space}")
    obs_dim = check_vector_obs(cfg, observation_space, "SAC")
    act_dim = int(np.prod(action_space.shape))
    device, world_size = fabric.device, fabric.world_size
    n_envs = int(cfg.env.num_envs) * world_size

    agent = build_agent_state(obs_dim, act_dim, int(cfg.algo.actor.hidden_size), int(cfg.algo.critic.hidden_size),
                              int(cfg.algo.critic.n), float(cfg.algo.alpha.alpha),
                              torch.Generator().manual_seed(int(cfg.seed)), device=device)
    state = build_optimizers_and_state(cfg, agent, generator=generator)
    scale, bias = action_bounds(action_space)
    state["action_scale"], state["action_bias"] = torch.as_tensor(scale).to(device), torch.as_tensor(bias).to(device)
    resumed = read_sac_resume(fabric, cfg, state)

    aggregator = None
    if not MetricAggregator.disabled:
        aggregator = instantiate(cfg.metric.aggregator)
    replay = replay_config(cfg)
    replay_shards = int(replay.get("shards", 1) or 1)
    num_players, envs_per_player = plane_env_split(cfg, n_envs)
    if replay_shards > 1 and replay_shards != num_players:
        raise ValueError(f"replay.shards={replay_shards} requires plane.num_players={replay_shards} so each player "
                         f"process owns exactly one shard (got plane.num_players={num_players})")
    if bool(replay.get("adopt_slabs", False)):
        raise NotImplementedError(
            "replay.adopt_slabs=True lands slabs in the device ring, which the port has on env.backend=jax only: "
            "the device ring on the Python plane is ROADMAP queue A item 6j (pass replay.adopt_slabs=False)"
        )
    rb = make_replay_buffer(cfg, fabric, log_dir, n_envs=n_envs, obs_keys=("observations",), dry_run_size=1,
                            shards=replay_shards)
    if resumed is not None and cfg.buffer.get("checkpoint", False) and "rb" in resumed:
        rb.load_state_dict(resumed["rb"])
    staging = make_replay_staging(cfg, fabric, rb, seed=cfg.seed)
    program = build_train_fn(cfg, act_dim, -float(act_dim), emit_td=needs_td_writeback(cfg))
    train_round = sac_train_round(cfg, program, state, n_envs)

    start_step = int(np.asarray(resumed["update"])) // world_size if resumed is not None else 1
    policy_step = int(np.asarray(resumed["update"])) * int(cfg.env.num_envs) if resumed is not None else 0
    last_log = int(np.asarray(resumed["last_log"])) if resumed is not None else 0
    last_checkpoint = int(np.asarray(resumed["last_checkpoint"])) if resumed is not None else 0
    warn_checkpoint_rounding(cfg, n_envs)
    num_updates = int(cfg.total_steps // n_envs) if not cfg.dry_run else 1
    learning_starts = cfg.algo.learning_starts // n_envs if not cfg.dry_run else 0
    if cfg.checkpoint.resume_from and not cfg.buffer.get("checkpoint", False):
        learning_starts += start_step
    act_burst = max(int(cfg.env.get("act_burst", 1) or 1), 1)
    first_train_update = max(learning_starts, start_step)
    scalars = {"num_updates": num_updates, "learning_starts": learning_starts,
               "first_train_update": first_train_update, "act_burst": act_burst,
               "max_policy_lag": int((cfg.get("plane", {}) or {}).get("max_policy_lag", 0) or 0)}
    spec = SlabSpec.from_arrays(sac_slab_example(act_burst, envs_per_player, obs_dim, act_dim,
                                                 not cfg.buffer.sample_next_obs))

    seconds = PhaseSeconds("plane_wait", "ingest", "sample_and_train", "publish", "checkpoint", "test",
                           *PLAYER_PHASES)
    counters = {"updates": 0, "player_steps": 0, "random_steps": 0, "gradient_steps": 0, "train_bursts": 0,
                "ema_steps": 0}
    episode_returns: List[float] = []
    loss_sum, loss_count = None, 0
    train_step = last_train = 0
    checkpoint_path = None
    plane = build_plane(cfg, spec=spec, entry="sheeprl_tpu_torch.algos.sac.player:run_player", run_player=run_player,
                        scalars=scalars, start_update=start_step, n_envs=n_envs,
                        log_dir=log_dir, thread_name="sac-player", initial_params=host_params(state["actor"]))
    replay_plane = ReplayPlane(plane, rb) if replay_shards > 1 else None
    update = start_step
    try:
        while update <= num_updates:
            n_act, random_phase = burst_plan(update, act_burst, learning_starts, num_updates)
            first, last = update, update + n_act - 1
            with seconds.phase("plane_wait"), span("Time/plane_wait_time", SumMetric(), phase="plane_wait"):
                handles = [plane.recv(p, update) for p in range(plane.n_players)]
            add_player_seconds(seconds, handles)
            with seconds.phase("ingest"):
                if replay_plane is not None:
                    ep_stats = replay_plane.ingest(handles, n_act)
                else:
                    if len(handles) == 1:
                        rows = {k: v[:n_act] for k, v in handles[0].data.items()}
                    else:
                        # the env axis in player order: the canonical seed order
                        rows = {k: np.concatenate([h.data[k][:n_act] for h in handles], axis=1)
                                for k in handles[0].data}
                    rb.add(rows)
                    ep_stats = [s for h in handles for s in h.ep_stats]
                    for h in handles:
                        h.release()
                policy_step += n_envs * n_act
                counters["updates"] += n_act
                counters["random_steps" if random_phase else "player_steps"] += n_act
                for ep_rew, ep_len in ep_stats:
                    episode_returns.append(ep_rew)
                    if cfg.metric.log_level > 0:
                        if aggregator and not aggregator.disabled:
                            aggregator.update("Rewards/rew_avg", ep_rew)
                            aggregator.update("Game/ep_len_avg", ep_len)
                        fabric.print(f"Rank-0: policy_step={policy_step}, reward={ep_rew}")

            calls = program.calls()
            with seconds.phase("sample_and_train"), span(
                "Time/train_time", SumMetric(sync_on_compute=cfg.metric.sync_on_compute), phase="train"
            ):
                metrics = train_round(staging, first, last, learning_starts, counters)
            if metrics is not None:
                loss_sum = metrics.clone() if loss_sum is None else loss_sum.add_(metrics)
                loss_count += 1
                train_step += world_size
                if first > learning_starts:  # a round past the catch-up burst
                    register_step_cost(program.step, dispatches_per_step=program.calls() - calls,
                                       world_size=world_size)
            if last >= learning_starts:
                # the parameter broadcast: also with per_rank_gradient_steps=0, or the players would wait forever
                with seconds.phase("publish"):
                    plane.publish(version_after(last, first_train_update), host_params(state["actor"]))

            if cfg.metric.log_level > 0 and (policy_step - last_log >= cfg.metric.log_every or last == num_updates):
                if aggregator and not aggregator.disabled:
                    if loss_sum is not None:
                        for name, value in zip(LOSS_NAMES, (loss_sum / loss_count).tolist()):
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
                    agent_tree, opt_states = agent_state_dict(state, _MODULES)
                    ckpt_state = {"agent": agent_tree, "opt_states": opt_states, "update": last * world_size,
                                  "batch_size": cfg.per_rank_batch_size * world_size, "last_log": last_log,
                                  "last_checkpoint": last_checkpoint}
                    checkpoint_path = os.path.join(log_dir, "checkpoint", f"ckpt_{policy_step}_{fabric.global_rank}")
                    fabric.call("on_checkpoint_coupled", ckpt_path=checkpoint_path, state=ckpt_state,
                                replay_buffer=rb if cfg.buffer.get("checkpoint", False) else None)
                if preemption_requested():
                    break  # the final checkpoint is written; the drain below joins the players
            update = last + 1
    finally:
        plane.drain()
        staging.close()

    test_reward, test_steps = None, 0
    if fabric.is_global_zero and cfg.algo.get("run_test", True) and not preemption_requested():
        with seconds.phase("test"):
            test_reward, test_steps = test(sac_greedy(state, cfg), fabric, cfg, log_dir)
    if logger is not None:
        logger.close()
    return learner_result(
        plane, num_players, counters, seconds, policy_steps=policy_step, learning_starts=learning_starts,
        episode_returns=episode_returns, test_steps=test_steps, test_reward=test_reward, log_dir=log_dir,
        event_file=None if logger is None else logger.path, checkpoint=checkpoint_path,
        graphs={"train": _graph_counts([] if program.static is None else [program.static.step])},
    )

"""PPO, decoupled: the learner on the actor–learner plane (counterpart of
``sheeprl_tpu/algos/ppo/ppo_decoupled.py``), registered as
``ppo_decoupled``.

Collection runs in :func:`~sheeprl_tpu_torch.algos.ppo.player.run_player`
on the plane ``plane.num_players`` picks (one player thread, or N player
processes, each with its slice of the envs through the worker pool, acting
on the CPU). Each update the learner assembles the players' rollout slabs
(the env axis in player order: the canonical seed order), runs GAE
(:class:`~sheeprl_tpu_torch.algos.ppo.ppo.GaeStep`) and the coupled PPO's
update (:class:`~sheeprl_tpu_torch.algos.ppo.ppo.UpdateProgram`, one CUDA
graph replay a minibatch step on the card) on it, and publishes the agent as
version ``version_after(update, start_step)``. The stored behaviour
log-probs keep the clipped objective exact under the protocol's one-update
lead; at ``plane.max_policy_lag=0`` a seeded 1-player process run is
bitwise the thread run.

The checkpoint holds the coupled PPO's entries; a run resumes from the
port's checkpoints and from the JAX package's (converted). Like the JAX
entrypoint it refuses ``fabric.devices=1`` (``cli.check_configs``).
"""

from __future__ import annotations

import os
from types import SimpleNamespace
from typing import Any, Dict, List

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import _graph_counts
from sheeprl_tpu_torch.algos.ppo.agent import build_agent, greedy_actions
from sheeprl_tpu_torch.algos.ppo.player import ppo_slab_example, run_player
from sheeprl_tpu_torch.algos.ppo.ppo import (
    LOSS_NAMES,
    PPO,
    GaeStep,
    build_optimizer,
    flat_env_major,
    load_resume,
    optimizer_entry,
)
from sheeprl_tpu_torch.algos.ppo.utils import normalize_obs, prepare_obs, test
from sheeprl_tpu_torch.algos.sac.sac import unsupported
from sheeprl_tpu_torch.algos.sac.sac_decoupled import (
    PLAYER_PHASES,
    add_player_seconds,
    host_params,
    learner_result,
    probe_spaces,
)
from sheeprl_tpu_torch.ckpt import preemption_requested, should_checkpoint, warn_checkpoint_rounding
from sheeprl_tpu_torch.config.instantiate import instantiate
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.evals.builders import actions_dim_of
from sheeprl_tpu_torch.obs.perf import PhaseSeconds, log_sps_metrics, register_step_cost
from sheeprl_tpu_torch.obs.prof.capture import profile_tick
from sheeprl_tpu_torch.obs.spans import span
from sheeprl_tpu_torch.plane import SlabSpec, build_plane, plane_env_split, version_after
from sheeprl_tpu_torch.utils.logger import create_tensorboard_logger
from sheeprl_tpu_torch.utils.metric import MetricAggregator, SumMetric
from sheeprl_tpu_torch.utils.optim import set_lr
from sheeprl_tpu_torch.utils.registry import register_algorithm
from sheeprl_tpu_torch.utils.utils import polynomial_decay, save_configs

__all__ = ["assemble_rollout", "main", "rollout_update_data"]


def assemble_rollout(handles) -> Dict[str, np.ndarray]:
    """One update's rollout from the players' slabs: the env axis in player
    order (the canonical seed order); views of the slab when there is one
    player."""
    if len(handles) == 1:
        return dict(handles[0].data)
    return {k: np.concatenate([h.data[k] for h in handles], axis=1) for k in handles[0].data}


def rollout_update_data(rollout: Dict[str, np.ndarray], obs_keys, gae_step: GaeStep) -> Dict[str, Any]:
    """GAE over the rollout (bootstrapped by its ``next_values``) and the
    update's data flattened env-major, as the coupled loop gives its
    update (``PPO.update_data``)."""
    returns, advantages = gae_step(rollout["rewards"], rollout["values"], rollout["dones"], rollout["next_values"][0])
    data = {k: flat_env_major(rollout[k]) for k in (*obs_keys, "actions", "values", "logprobs")}
    data["returns"], data["advantages"] = flat_env_major(returns), flat_env_major(advantages)
    return data


@register_algorithm(decoupled=True)
def main(fabric, cfg) -> Dict[str, Any]:
    """The decoupled PPO learner. Returns the coupled loop's counters and,
    by phase, its host seconds (``plane_wait``: waiting for the players'
    rollouts) and the players' (``PLAYER_PHASES``, summed over the players)."""
    if "minedojo" in str(cfg.env.wrapper.get("_target_", "") or "").lower():
        raise ValueError(
            "MineDojo is not currently supported by PPO agent, since it does not take into consideration the action "
            "masks provided by the environment. As an alternative you can use one of the Dreamers' agents."
        )
    unsupported(cfg, "PPO")
    generator, _ = fabric.seed_everything(cfg.seed)
    logger, log_dir = create_tensorboard_logger(cfg)
    fabric.logger = logger
    if logger is not None:
        logger.log_hyperparams(cfg.as_dict() if hasattr(cfg, "as_dict") else dict(cfg))
    if fabric.is_global_zero:
        save_configs(cfg, log_dir)
    observation_space, action_space = probe_spaces(cfg)
    if not isinstance(observation_space, spaces.Dict):
        raise RuntimeError(f"Unexpected observation type, should be of type Dict, got: {observation_space}")
    if len(cfg.cnn_keys.encoder) + len(cfg.mlp_keys.encoder) == 0:
        raise RuntimeError("You should specify at least one CNN keys or MLP keys from the cli: "
                           "`cnn_keys.encoder=[rgb]` or `mlp_keys.encoder=[state]`")
    device, world_size = fabric.device, fabric.world_size
    n_envs = int(cfg.env.num_envs) * world_size
    cnn_keys, mlp_keys = list(cfg.cnn_keys.encoder), list(cfg.mlp_keys.encoder)
    obs_keys = mlp_keys + cnn_keys
    actions_dim, is_continuous = actions_dim_of(action_space)
    act_width = int(np.prod(action_space.shape)) if is_continuous else int(sum(actions_dim))
    run = SimpleNamespace(actions_dim=actions_dim, is_continuous=is_continuous, cnn_keys=cnn_keys, obs_keys=obs_keys,
                          generator=generator)
    agent = build_agent(cfg, actions_dim, is_continuous, cnn_keys, mlp_keys, observation_space,
                        torch.Generator().manual_seed(int(cfg.seed)), device=device)
    optimizer = build_optimizer(cfg, agent)
    family = SimpleNamespace(agent=agent, optimizer=optimizer, batch_entry="batch_size")
    resumed = load_resume(fabric, cfg, family)
    rollout_steps = int(cfg.algo.rollout_steps)
    program = PPO.make_program(cfg, agent, optimizer, run, PPO.samples(cfg) * world_size, device)
    gae_step = GaeStep(float(cfg.algo.gamma), float(cfg.algo.gae_lambda), device)
    aggregator = None
    if not MetricAggregator.disabled:
        aggregator = instantiate(cfg.metric.aggregator)

    start_step = int(np.asarray(resumed["update"])) // world_size if resumed is not None else 1
    policy_steps_per_update = n_envs * rollout_steps
    num_updates = int(cfg.total_steps) // policy_steps_per_update if not cfg.dry_run else 1
    last_log = int(np.asarray(resumed["last_log"])) if resumed is not None else 0
    last_checkpoint = int(np.asarray(resumed["last_checkpoint"])) if resumed is not None else 0
    policy_step = (start_step - 1) * policy_steps_per_update
    warn_checkpoint_rounding(cfg, policy_steps_per_update)
    initial_ent_coef, initial_clip_coef = float(cfg.algo.ent_coef), float(cfg.algo.clip_coef)
    num_players, envs_per_player = plane_env_split(cfg, n_envs)
    spec = SlabSpec.from_arrays(ppo_slab_example(rollout_steps, envs_per_player, observation_space, cnn_keys,
                                                 mlp_keys, act_width))
    scalars = {"num_updates": num_updates, "learning_starts": 0, "first_train_update": start_step,
               "act_burst": 1, "max_policy_lag": int((cfg.get("plane", {}) or {}).get("max_policy_lag", 0) or 0)}

    seconds = PhaseSeconds("plane_wait", "gae_and_stage", "train", "publish", "checkpoint", "test",
                           *PLAYER_PHASES)
    counters = {"updates": 0, "gradient_steps": 0}
    episode_returns: List[float] = []
    loss_sum, loss_count = None, 0
    train_step = last_train = 0
    checkpoint_path = None
    plane = build_plane(cfg, spec=spec, entry="sheeprl_tpu_torch.algos.ppo.player:run_player", run_player=run_player,
                        scalars=scalars, start_update=start_step, n_envs=n_envs,
                        log_dir=log_dir, thread_name="ppo-player", initial_params=host_params(agent))
    try:
        for update in range(start_step, num_updates + 1):
            lr = float(cfg.algo.optimizer.lr)
            if cfg.algo.get("anneal_lr", False):
                lr = polynomial_decay(update - 1, initial=float(cfg.algo.optimizer.lr), final=0.0,
                                      max_decay_steps=num_updates, power=1.0)
                set_lr(optimizer, lr)
            with seconds.phase("plane_wait"), span("Time/plane_wait_time", SumMetric(), phase="plane_wait"):
                handles = [plane.recv(p, update) for p in range(plane.n_players)]
            add_player_seconds(seconds, handles)
            policy_step += policy_steps_per_update
            ep_stats = [s for h in handles for s in h.ep_stats]
            with seconds.phase("gae_and_stage"):
                data = rollout_update_data(assemble_rollout(handles), obs_keys, gae_step)
            with seconds.phase("train"), span(
                "Time/train_time", SumMetric(sync_on_compute=cfg.metric.sync_on_compute), phase="train"
            ):
                metrics = program.update(data, [float(cfg.algo.clip_coef), float(cfg.algo.ent_coef)])
                for h in handles:  # the update's load copied the rows out
                    h.release()
            minibatch_steps = program.epochs * program.n_minibatches
            register_step_cost(program.step, dispatches_per_step=minibatch_steps, world_size=world_size)
            with seconds.phase("publish"):
                plane.publish(version_after(update, start_step), host_params(agent))
            counters["gradient_steps"] += minibatch_steps
            counters["updates"] += 1
            loss_sum = metrics.clone() if loss_sum is None else loss_sum.add_(metrics)
            loss_count += 1
            train_step += world_size
            for ep_rew, ep_len in ep_stats:
                episode_returns.append(ep_rew)
                if cfg.metric.log_level > 0:
                    if aggregator and not aggregator.disabled:
                        aggregator.update("Rewards/rew_avg", ep_rew)
                        aggregator.update("Game/ep_len_avg", ep_len)
                    fabric.print(f"Rank-0: policy_step={policy_step}, reward={ep_rew}")

            if cfg.metric.log_level > 0 and logger is not None:
                logger.log_metrics({"Info/learning_rate": lr}, policy_step)
                logger.log_metrics({"Info/clip_coef": float(cfg.algo.clip_coef)}, policy_step)
                logger.log_metrics({"Info/ent_coef": float(cfg.algo.ent_coef)}, policy_step)
            if cfg.metric.log_level > 0 and (policy_step - last_log >= cfg.metric.log_every or update == num_updates):
                if aggregator and not aggregator.disabled:
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
            if cfg.algo.get("anneal_clip_coef", False):
                cfg.algo.clip_coef = polynomial_decay(update, initial=initial_clip_coef, final=0.0,
                                                      max_decay_steps=num_updates, power=1.0)
            if cfg.algo.get("anneal_ent_coef", False):
                cfg.algo.ent_coef = polynomial_decay(update, initial=initial_ent_coef, final=0.0,
                                                     max_decay_steps=num_updates, power=1.0)
            if should_checkpoint(cfg, policy_step, last_checkpoint, update, num_updates):
                with seconds.phase("checkpoint"), span("Time/checkpoint_time", phase="checkpoint"):
                    last_checkpoint = policy_step
                    ckpt_state = {"params": {k: v.detach() for k, v in agent.state_dict().items()},
                                  "opt_state": optimizer_entry(optimizer),
                                  "batch_size": int(cfg.per_rank_batch_size) * world_size,
                                  "update": update * world_size,
                                  "last_log": last_log, "last_checkpoint": last_checkpoint}
                    checkpoint_path = os.path.join(log_dir, "checkpoint", f"ckpt_{policy_step}_{fabric.global_rank}")
                    fabric.call("on_checkpoint_coupled", ckpt_path=checkpoint_path, state=ckpt_state)
                if preemption_requested():
                    break  # the final checkpoint is written; the drain below joins the players
    finally:
        plane.drain()

    test_reward, test_steps = None, 0
    if fabric.is_global_zero and cfg.algo.get("run_test", True) and not preemption_requested():
        @torch.no_grad()
        def greedy(obs):
            prepared = prepare_obs(obs, cnn_keys, 1)
            norm = normalize_obs({k: torch.from_numpy(prepared[k]).to(device) for k in obs_keys}, cnn_keys, obs_keys)
            return greedy_actions(agent.pre_dist(norm), is_continuous).cpu().numpy()

        with seconds.phase("test"):
            test_reward, test_steps = test(greedy, fabric, cfg, log_dir)
    if logger is not None:
        logger.close()
    return learner_result(
        plane, num_players, counters, seconds, policy_steps=policy_step, episode_returns=episode_returns,
        test_steps=test_steps, test_reward=test_reward, log_dir=log_dir,
        event_file=None if logger is None else logger.path, checkpoint=checkpoint_path,
        graphs={"train": _graph_counts([program.step]),
                "gae": _graph_counts([] if gae_step.step is None else [gae_step.step])},
    )

"""PPO's player loop on the actor–learner plane (counterpart of
``sheeprl_tpu/algos/ppo/player.py``).

:func:`run_player` collects in both decoupled modes (a thread in the
learner's process, or a player process that imports it by dotted name).
One slab is one rollout of ``algo.rollout_steps`` steps of this player's
envs, plus the learner's GAE bootstrap ``next_values``. The player acts on
the CPU with its own copy of the whole agent (policy and value head),
loaded from the version the protocol names, and frozen for the rollout: it
stores the behaviour values and log-probs, adds ``V(s′)`` of a truncated
env's final observation to its reward, and closes the rollout with
``V(s_T)``, as the coupled loop does with the learner's agent. Its noise
comes from a generator seeded by the run's seed and the player's index.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from sheeprl_tpu_torch.algos.sac.player import episode_stats, load_params, player_envs
from sheeprl_tpu_torch.obs.counters import add_rollout_burst
from sheeprl_tpu_torch.obs.spans import span
from sheeprl_tpu_torch.utils.metric import SumMetric

__all__ = ["ppo_slab_example", "run_player"]


def ppo_slab_example(rollout_steps: int, n_envs: int, observation_space, cnn_keys: Sequence[str],
                     mlp_keys: Sequence[str], act_width: int) -> Dict[str, np.ndarray]:
    """Arrays fixing PPO's slab layout: one rollout of ``rollout_steps``
    steps of ``n_envs`` envs, each prepared observation key, and the
    one-row ``next_values``."""
    from sheeprl_tpu_torch.algos.ppo.utils import prepare_obs

    raw = {k: np.zeros((n_envs, *observation_space[k].shape), observation_space[k].dtype)
           for k in list(cnn_keys) + list(mlp_keys)}
    example = {k: np.zeros((rollout_steps, *v.shape), v.dtype) for k, v in prepare_obs(raw, cnn_keys, n_envs).items()}
    example.update({
        "dones": np.zeros((rollout_steps, n_envs, 1), np.float32),
        "values": np.zeros((rollout_steps, n_envs, 1), np.float32),
        "actions": np.zeros((rollout_steps, n_envs, act_width), np.float32),
        "logprobs": np.zeros((rollout_steps, n_envs, 1), np.float32),
        "rewards": np.zeros((rollout_steps, n_envs, 1), np.float32),
        "next_values": np.zeros((1, n_envs, 1), np.float32),
    })
    return example


def run_player(ctx) -> None:
    """Collect updates ``ctx.start_update .. num_updates`` of this player's
    envs, one slab a rollout."""
    envs = player_envs(ctx)
    try:
        _collect(ctx, envs)
    finally:
        ctx.close_watchdog()
        envs.close()


def _collect(ctx, envs) -> None:
    import torch

    from sheeprl_tpu_torch.algos.ppo.agent import build_agent, draw_noise, sample_actions
    from sheeprl_tpu_torch.algos.ppo.utils import normalize_obs, prepare_obs
    from sheeprl_tpu_torch.envs.vector import env_seeds
    from sheeprl_tpu_torch.evals.builders import actions_dim_of

    cfg = ctx.cfg
    n_envs = int(ctx.n_envs)
    cnn_keys, mlp_keys = list(cfg.cnn_keys.encoder), list(cfg.mlp_keys.encoder)
    obs_keys = mlp_keys + cnn_keys
    rollout_steps = int(cfg.algo.rollout_steps)
    actions_dim, is_continuous = actions_dim_of(envs.single_action_space)
    agent = build_agent(cfg, actions_dim, is_continuous, cnn_keys, mlp_keys, envs.single_observation_space).eval()
    generator = torch.Generator().manual_seed(int(ctx.seed))

    def norm(obs: Dict[str, np.ndarray]):
        return normalize_obs({k: torch.from_numpy(np.ascontiguousarray(obs[k])) for k in obs_keys}, cnn_keys,
                             obs_keys)

    obs = prepare_obs(envs.reset(seed=env_seeds(int(cfg.seed), int(ctx.env_rank), n_envs))[0], cnn_keys, n_envs)
    update = int(ctx.start_update)
    while update <= ctx.num_updates and not ctx.stop.is_set() and not ctx.orphaned():
        version, params = ctx.wait_policy(update)
        load_params(agent, params)
        token, views = ctx.acquire_slab()
        ep_stats: List[Tuple[float, float]] = []
        for r in range(rollout_steps):
            add_rollout_burst(act_dispatches=1)
            with ctx.timed("act"), torch.no_grad():
                pre_dist, values = agent(norm(obs))
                actions, real, logprob = sample_actions(
                    pre_dist, is_continuous, draw_noise(actions_dim, is_continuous, (n_envs,), generator, "cpu"))
            with ctx.timed("env"), span("Time/env_interaction_time", SumMetric(), phase="env"):
                next_o, rewards, terminated, truncated, infos = envs.step(real.numpy().reshape(envs.action_space.shape))
            ctx.beat()  # a hung envs.step() must fire the stall watchdog
            rewards = np.asarray(rewards, np.float32).reshape(n_envs).copy()
            truncated_envs = np.nonzero(truncated)[0]
            if len(truncated_envs) > 0:
                # V(s') of the final observation into the reward, at the rollout's frozen parameters
                final = infos["final_obs"]
                t_obs = prepare_obs({k: np.stack([np.asarray(final[e][k]) for e in truncated_envs]) for k in obs_keys},
                                    cnn_keys, len(truncated_envs))
                with torch.no_grad():
                    rewards[truncated_envs] += agent.get_value(norm(t_obs)).numpy().reshape(-1)
            for k in obs_keys:
                views[k][r] = obs[k]
            views["dones"][r] = np.logical_or(terminated, truncated).astype(np.float32).reshape(n_envs, 1)
            views["values"][r] = values.numpy().reshape(n_envs, 1)
            views["actions"][r] = actions.numpy().astype(np.float32).reshape(n_envs, -1)
            views["logprobs"][r] = logprob.numpy().reshape(n_envs, 1)
            views["rewards"][r] = rewards.reshape(n_envs, 1)
            ep_stats += episode_stats(infos)
            obs = prepare_obs(next_o, cnn_keys, n_envs)
        with torch.no_grad():
            views["next_values"][0] = agent.get_value(norm(obs)).numpy().reshape(n_envs, 1)
        ctx.emit(token, views, update, rollout_steps, version, ep_stats)
        update += 1

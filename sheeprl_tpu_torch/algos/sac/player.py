"""SAC's player loop on the actor–learner plane (counterpart of
``sheeprl_tpu/algos/sac/player.py``).

:func:`run_player` collects in both decoupled modes: as a thread in the
learner's process (``plane.num_players=0``) and in a player process, which
imports it by dotted name. It

- owns this player's slice of the envs (the canonical ``env_seeds``
  partition: player ``p`` of ``E`` envs gets ``seed + p·E + i``, so player 0
  of a 1-player plane seeds as the thread does);
- acts on the CPU with its own copy of the actor, loaded from the published
  version the protocol names (:meth:`PlayerContext.wait_policy`), its noise
  from a generator seeded by the run's seed and the player's index only;
- commits each burst (one update: ``env.act_burst`` is 1 on the Python
  plane) as one trajectory slab.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

from sheeprl_tpu_torch.obs.counters import add_rollout_burst
from sheeprl_tpu_torch.obs.spans import span
from sheeprl_tpu_torch.utils.metric import SumMetric

__all__ = ["run_player", "sac_slab_example"]


def sac_slab_example(capacity: int, n_envs: int, obs_dim: int, act_dim: int,
                     store_next_obs: bool) -> Dict[str, np.ndarray]:
    """Arrays fixing SAC's slab layout: one burst of up to ``capacity``
    steps of ``n_envs`` envs."""
    example = {
        "observations": np.zeros((capacity, n_envs, obs_dim), np.float32),
        "actions": np.zeros((capacity, n_envs, act_dim), np.float32),
        "rewards": np.zeros((capacity, n_envs, 1), np.float32),
        "dones": np.zeros((capacity, n_envs, 1), np.float32),
    }
    if store_next_obs:
        example["next_observations"] = np.zeros((capacity, n_envs, obs_dim), np.float32)
    return example


def player_envs(ctx):
    """This player's vector env: a player process defaults to the
    shared-memory pool; a respawned player offsets its env seeds, so that it
    does not replay the trajectories its predecessor collected."""
    from sheeprl_tpu_torch.envs.vector import make_vector_env

    cfg = ctx.cfg
    if ctx.process_mode and cfg.env.get("vectorization", None) is None and cfg.env.get("sync_env", None) is None:
        cfg.env.vectorization = "async"
    if ctx.restart_count:
        cfg.seed = int(cfg.seed) + 7919 * int(ctx.restart_count)
    return make_vector_env(cfg, fabric=None, log_dir=ctx.log_dir if ctx.player_idx == 0 else None,
                           n_envs=int(ctx.n_envs), rank=ctx.env_rank)


def episode_stats(infos: Dict[str, Any]) -> List[Tuple[float, float]]:
    """``(return, length)`` of every episode that ended this step."""
    fi = infos.get("final_info")
    if not isinstance(fi, dict) or "episode" not in fi:
        return []
    return [(float(fi["episode"]["r"][i]), float(fi["episode"]["l"][i]))
            for i in np.nonzero(np.asarray(fi.get("_episode", []), dtype=bool))[0]]


def load_params(module, params: Dict[str, Any]) -> None:
    """A published version's host arrays into the player's CPU module."""
    import torch

    module.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in params.items()})


def run_player(ctx) -> None:
    """Collect updates ``ctx.start_update .. num_updates`` of this player's
    envs, one slab a burst."""
    envs = player_envs(ctx)
    try:
        _collect(ctx, envs)
    finally:
        ctx.close_watchdog()
        envs.close()


def _collect(ctx, envs) -> None:
    import torch

    from sheeprl_tpu_torch.algos.sac.agent import SACActor, action_bounds, squash_sample
    from sheeprl_tpu_torch.algos.sac.utils import concat_obs
    from sheeprl_tpu_torch.envs.vector import env_seeds
    from sheeprl_tpu_torch.plane.protocol import burst_plan

    cfg = ctx.cfg
    n_envs = int(ctx.n_envs)
    mlp_keys = list(cfg.mlp_keys.encoder)
    store_next_obs = not bool(cfg.buffer.sample_next_obs)
    act_dim = int(np.prod(envs.single_action_space.shape))
    obs_dim = int(sum(np.prod(envs.single_observation_space[k].shape) for k in mlp_keys))
    scale, bias = (torch.as_tensor(b) for b in action_bounds(envs.single_action_space))
    actor = SACActor(obs_dim, act_dim, int(cfg.algo.actor.hidden_size)).eval()
    generator = torch.Generator().manual_seed(int(ctx.seed))
    # the random prefill's draws: the same in a thread and in a process
    envs.action_space.seed(int(cfg.seed) + 1_000_003 * (int(ctx.env_rank) + 1))
    obs = concat_obs(envs.reset(seed=env_seeds(int(cfg.seed), int(ctx.env_rank), n_envs))[0], mlp_keys, n_envs)

    update, version, loaded = int(ctx.start_update), 0, None
    while update <= ctx.num_updates and not ctx.stop.is_set() and not ctx.orphaned():
        n_act, random_phase = burst_plan(update, ctx.act_burst, ctx.learning_starts, ctx.num_updates)
        if not random_phase:
            version, params = ctx.wait_policy(update)
            if version != loaded:
                load_params(actor, params)
                loaded = version
        token, views = ctx.acquire_slab()
        ep_stats: List[Tuple[float, float]] = []
        for r in range(n_act):
            with ctx.timed("act"):
                if random_phase:
                    actions = np.asarray(envs.action_space.sample(), np.float32)
                else:
                    add_rollout_burst(act_dispatches=1)
                    eps = torch.randn((n_envs, act_dim), generator=generator)
                    with torch.no_grad():
                        mean, std = actor(torch.from_numpy(obs))
                        actions = squash_sample(mean, std, eps, scale, bias)[0].numpy()
            with ctx.timed("env"), span("Time/env_interaction_time", SumMetric(), phase="env"):
                next_o, rewards, terminated, truncated, infos = envs.step(actions.reshape(envs.action_space.shape))
            ctx.beat()  # a hung envs.step() must fire the stall watchdog
            ep_stats += episode_stats(infos)
            next_obs = concat_obs(next_o, mlp_keys, n_envs)
            views["observations"][r] = obs
            views["actions"][r] = actions.reshape(n_envs, -1)
            views["rewards"][r] = np.asarray(rewards, np.float32).reshape(n_envs, 1)
            views["dones"][r] = np.logical_or(terminated, truncated).astype(np.float32).reshape(n_envs, 1)
            if store_next_obs:
                # the real next observation: an ended env's final_obs, not its reset one
                real_next = next_obs.copy()
                for idx, final_obs in enumerate(infos.get("final_obs", ())):
                    if final_obs is not None:
                        real_next[idx] = concat_obs({k: np.asarray(v)[None] for k, v in final_obs.items()},
                                                    mlp_keys, 1)[0]
                views["next_observations"][r] = real_next
            obs = next_obs
        ctx.emit(token, views, update, n_act, version, ep_stats)
        update += n_act

"""Plan2Explore on DreamerV3, the finetuning phase (counterpart of
``sheeprl_tpu/algos/p2e_dv3/p2e_dv3_finetuning.py``), registered as
``p2e_dv3_finetuning``.

The run starts from an exploration checkpoint (``checkpoint.
exploration_ckpt_path``, the port's or the JAX package's) and inherits every
model setting of the exploration run's config (the CLI hands that config
over as ``exploration_cfg`` and has copied its env keys). It trains with
DreamerV3's plain step: the world model, the task actor and the task critic,
from the exploration's weights and the task ``Moments``, with fresh
optimizers. The player acts with the exploration actor (frozen) from the
first step, with no random prefill, and with the task actor from
``learning_starts`` on. On the card each actor has its own captured acting
step (one CUDA graph each, both reading the one world model in place); at the
switch the task actor's step carries on from the player state as it stands.
``buffer.load_from_exploration`` restores the exploration run's buffer. The
checkpoint is DreamerV3's with the exploration actor beside the agent; a
resumed finetuning run reads it back, and the final test plays the task
actor.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import read_resume_checkpoint
from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent, build_player_fns
from sheeprl_tpu_torch.utils.registry import register_algorithm

__all__ = ["inherit_exploration_cfg", "load_exploration_checkpoint", "load_module_state", "main"]

#: the ``algo`` keys a finetuning run takes from its exploration run, besides the model groups
ALGO_KEYS = ("gamma", "lmbda", "horizon", "layer_norm", "dense_units", "mlp_layers", "dense_act", "cnn_act",
             "unimix", "hafner_initialization")
MODEL_GROUPS = ("world_model", "actor", "critic", "ensembles", "critics_exploration")


def inherit_exploration_cfg(cfg, exploration_cfg, algo_keys=ALGO_KEYS, groups=MODEL_GROUPS) -> None:
    """Every model setting of the exploration run (``algo_keys``, the
    ``groups`` of ``algo``, ``env.clip_rewards`` and the encoder and decoder
    keys), and its env count when the exploration buffer is loaded."""
    for k in algo_keys:
        cfg.algo[k] = exploration_cfg.algo[k]
    for k in groups:
        if k in exploration_cfg.algo:
            cfg.algo[k] = exploration_cfg.algo[k]
    cfg.env.clip_rewards = exploration_cfg.env.clip_rewards
    cfg.cnn_keys = exploration_cfg.cnn_keys
    cfg.mlp_keys = exploration_cfg.mlp_keys
    if cfg.buffer.get("load_from_exploration", False) and exploration_cfg.buffer.checkpoint:
        cfg.env.num_envs = exploration_cfg.env.num_envs


def load_exploration_checkpoint(fabric, path: str, convert) -> Dict[str, Any]:
    """An exploration checkpoint of either package as ``{"trees": {name:
    state_dict}, "task_moments", "expl_decay_steps", "rb"}``: the port's
    trees as they are, the JAX package's ``agent.params`` through
    ``convert`` (``convert_p2e_dv3`` or ``convert_p2e_dv2``); the task
    ``Moments`` state (None without one, as in P2E-DV2)."""
    state = fabric.load(path)
    agent = state["agent"]
    if "params" in agent:
        trees, _ = convert(agent["params"], training=True)
    else:
        trees = {k: v for k, v in agent.items() if k not in ("opt", "moments")}
    moments = (agent.get("moments", None) or {}).get("task", None)
    return {"trees": trees, "task_moments": moments, "expl_decay_steps": int(state["expl_decay_steps"]),
            "rb": state.get("rb", None)}


def load_module_state(module: torch.nn.Module, sd) -> None:
    """``module.load_state_dict`` of a checkpoint's numpy tree."""
    module.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()})


@register_algorithm()
def main(fabric, cfg, exploration_cfg) -> Dict[str, Any]:
    """The finetuning run (``dreamer_v3.train_loop`` with the actor switch).
    Returns the loop's result."""
    from sheeprl_tpu_torch.convert import convert_p2e_dv3

    dv3._unsupported(cfg)
    inherit_exploration_cfg(cfg, exploration_cfg)
    dv3.check_actor_cls(cfg)
    run = dv3.open_dv3_run(fabric, cfg)
    world_model, actor, critic, target_critic = build_agent(
        cfg, run.actions_dim, run.is_continuous, run.observation_space.spaces, seed=cfg.seed, device=run.device,
        training=True,
    )
    state = dv3.build_optimizers_and_state(cfg, world_model, actor, critic, target_critic, generator=run.generator)
    actor_exploration = copy.deepcopy(actor).requires_grad_(False)

    resumed = read_resume_checkpoint(fabric, cfg)
    replay_state, expl_decay_steps = None, None
    if resumed is not None:
        dv3.load_agent_state(state, resumed["agent"])
        load_module_state(actor_exploration, resumed["actor_exploration"])
        if cfg.buffer.get("checkpoint", False):
            replay_state = resumed.get("rb")
    else:
        loaded = load_exploration_checkpoint(fabric, cfg.checkpoint.exploration_ckpt_path, convert_p2e_dv3)
        trees = loaded["trees"]
        for name, tree in (("world_model", "world_model"), ("actor", "actor_task"), ("critic", "critic_task"),
                           ("target_critic", "target_critic_task")):
            load_module_state(state[name], trees[tree])
        load_module_state(actor_exploration, trees["actor_exploration"])
        if loaded["task_moments"]:
            with torch.no_grad():
                for k, v in state["moments"].items():
                    v.copy_(torch.as_tensor(np.asarray(loaded["task_moments"][k])).reshape(()))
        expl_decay_steps = loaded["expl_decay_steps"]
        if cfg.buffer.get("load_from_exploration", False):
            replay_state = loaded["rb"]

    wm = state["world_model"]
    task = build_player_fns(wm, actor, cfg, run.actions_dim, run.is_continuous)
    switch = str(cfg.algo.player.actor_type) == "exploration"
    players = [build_player_fns(wm, actor_exploration, cfg, run.actions_dim, run.is_continuous), task] if switch else [task]
    return dv3.train_loop(
        fabric, cfg, run, state, dv3.build_train_fn(cfg, run.actions_dim, run.is_continuous), resumed,
        players=players,
        checkpoint_state=lambda: {"agent": dv3.agent_state_dict(state),
                                  "actor_exploration": actor_exploration.state_dict()},
        publish=lambda: {"agent": {k: state[k].state_dict() for k in ("world_model", "actor")}},
        test_player=task,
        random_prefill=False,
        switch_at_learning_starts=switch,
        expl_decay_steps=expl_decay_steps,
        replay_state=replay_state,
    )

"""Plan2Explore on DreamerV1, the finetuning phase (counterpart of
``sheeprl_tpu/algos/p2e_dv1/p2e_dv1_finetuning.py``), registered as
``p2e_dv1_finetuning``.

As P2E-DV2's finetuning (``p2e_dv2/p2e_dv2_finetuning.py``) over
DreamerV1: the exploration run's model settings, DreamerV1's plain step
from the exploration checkpoint's world model, task actor and task critic
(the port's or the JAX package's), fresh optimizers, the sequential buffer
(or the exploration run's, ``buffer.load_from_exploration``), the player
acting with the frozen exploration actor from the first step and with the
task actor from ``learning_starts``, one captured acting step per actor,
and the exploration actor kept beside the agent in the checkpoint.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

from sheeprl_tpu_torch.algos.dreamer_v1 import dreamer_v1 as dv1
from sheeprl_tpu_torch.algos.dreamer_v1.agent import build_agent, build_player_fns
from sheeprl_tpu_torch.algos.dreamer_v2 import dreamer_v2 as dv2
from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_finetuning import (
    inherit_exploration_cfg,
    load_exploration_checkpoint,
    load_module_state,
)
from sheeprl_tpu_torch.utils.registry import register_algorithm

__all__ = ["main"]

#: the ``algo`` keys a finetuning run takes from its exploration run, besides the model groups
ALGO_KEYS = ("gamma", "lmbda", "horizon", "dense_units", "mlp_layers", "dense_act", "cnn_act")
MODEL_GROUPS = ("world_model", "actor", "critic", "ensembles")


@register_algorithm()
def main(fabric, cfg, exploration_cfg) -> Dict[str, Any]:
    """The finetuning run (``dreamer_v2.train_loop`` with the actor switch).
    Returns the loop's result."""
    from sheeprl_tpu_torch.convert import convert_p2e_dv1

    dv2._unsupported(cfg)
    inherit_exploration_cfg(cfg, exploration_cfg, ALGO_KEYS, MODEL_GROUPS)
    cfg.env.screen_size = 64
    cfg.env.frame_stack = 1
    run = dv2.open_run(fabric, cfg)
    world_model, actor, critic = build_agent(
        cfg, run.actions_dim, run.is_continuous, run.observation_space.spaces, seed=cfg.seed, device=run.device,
        training=True,
    )
    state = dv1.build_optimizers_and_state(cfg, world_model, actor, critic, generator=run.generator)
    actor_exploration = copy.deepcopy(actor).requires_grad_(False)

    resumed = dv2.read_resume_checkpoint(fabric, cfg)
    replay_state, expl_decay_steps = None, None
    if resumed is not None:
        dv1.load_agent_state(state, resumed["agent"])
        load_module_state(actor_exploration, resumed["actor_exploration"])
        if cfg.buffer.get("checkpoint", False):
            replay_state = resumed.get("rb")
    else:
        loaded = load_exploration_checkpoint(fabric, cfg.checkpoint.exploration_ckpt_path, convert_p2e_dv1)
        trees = loaded["trees"]
        for name, tree in (("world_model", "world_model"), ("actor", "actor_task"), ("critic", "critic_task")):
            load_module_state(state[name], trees[tree])
        load_module_state(actor_exploration, trees["actor_exploration"])
        expl_decay_steps = loaded["expl_decay_steps"]
        if cfg.buffer.get("load_from_exploration", False):
            replay_state = loaded["rb"]

    wm = state["world_model"]
    task = build_player_fns(wm, actor, cfg, run.actions_dim, run.is_continuous)
    switch = str(cfg.algo.player.actor_type) == "exploration"
    players = [task]
    if switch:
        players.insert(0, build_player_fns(wm, actor_exploration, cfg, run.actions_dim, run.is_continuous))
    return dv2.train_loop(
        fabric, cfg, run, state, dv1.build_train_fn(cfg, run.actions_dim, run.is_continuous), resumed,
        players=players,
        checkpoint_state=lambda: {"agent": dv1.agent_state_dict(state),
                                  "actor_exploration": actor_exploration.state_dict()},
        publish=lambda: {"agent": {k: state[k].state_dict() for k in ("world_model", "actor")}},
        test_player=task,
        buffer_kind="sequential",
        random_prefill=False,
        switch_at_learning_starts=switch,
        expl_decay_steps=expl_decay_steps,
        replay_state=replay_state,
        hard_target_updates=False,
    )

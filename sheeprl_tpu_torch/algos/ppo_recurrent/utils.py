"""Recurrent-PPO helpers (counterpart of
``sheeprl_tpu/algos/ppo_recurrent/utils.py``): PPO's observation staging
and metric allow-list, and the greedy policy that carries the LSTM state
through the test episode."""

from __future__ import annotations

from typing import Callable, Dict, Mapping

import numpy as np
import torch

from sheeprl_tpu_torch.algos.ppo.utils import AGGREGATOR_KEYS, normalize_obs, prepare_obs, test
from sheeprl_tpu_torch.algos.ppo_recurrent.agent import greedy_actions, one_hot_actions

__all__ = ["AGGREGATOR_KEYS", "normalize_obs", "prepare_obs", "recurrent_greedy", "test"]


def recurrent_greedy(agent, cnn_keys, mlp_keys, n: int, device) -> Callable[[Mapping[str, np.ndarray], Dict], tuple]:
    """``act(obs, state) -> (env actions, new state)``: one greedy step of
    ``n`` rows carrying ``state`` (``c``, ``h``, ``prev_actions``,
    ``is_first``, device tensors with the rows on axis 0; None starts the
    episode: zeros, ``is_first`` ones)."""
    obs_keys = list(mlp_keys) + list(cnn_keys)
    act_dim = int(sum(agent.actions_dim))

    def init_state(rows: int) -> Dict[str, torch.Tensor]:
        c, h = agent.initial_hc(rows, device)
        return {"c": c, "h": h, "prev_actions": torch.zeros((rows, act_dim), device=device),
                "is_first": torch.ones((rows, 1), device=device)}

    @torch.no_grad()
    def act(obs, state):
        if state is None:
            state = init_state(n)
        prepared = prepare_obs({k: obs[k] for k in obs_keys}, cnn_keys, n)
        norm = normalize_obs({k: torch.from_numpy(v).to(device)[None] for k, v in prepared.items()}, cnn_keys,
                             obs_keys)
        pre_dist, _, (c, h) = agent(norm, state["prev_actions"][None], state["is_first"][None],
                                    (state["c"], state["h"]))
        real = greedy_actions([p[0] for p in pre_dist], agent.is_continuous).cpu().numpy()
        prev = torch.from_numpy(one_hot_actions(real, agent.actions_dim, agent.is_continuous)).to(device)
        return real, {"c": c, "h": h, "prev_actions": prev, "is_first": torch.zeros((n, 1), device=device)}

    act.init_state = init_state
    return act

"""Eval-policy builders (counterpart of ``sheeprl_tpu/evals/builders.py``)."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from sheeprl_tpu_torch.evals.service import EvalPolicy

__all__ = ["actions_dim_of", "dreamer_eval_policy"]


def actions_dim_of(action_space) -> Tuple[Tuple[int, ...], bool]:
    """``(actions_dim, is_continuous)``: Discrete → ``[n]``, MultiDiscrete →
    ``nvec``, Box → its shape. Read from the space's attributes, so a
    gymnasium space and any object with ``n`` / ``nvec`` / ``shape`` work."""
    if hasattr(action_space, "nvec"):
        return tuple(int(v) for v in np.asarray(action_space.nvec).reshape(-1)), False
    if hasattr(action_space, "n"):
        return (int(action_space.n),), False
    return tuple(int(d) for d in action_space.shape), True


def dreamer_eval_policy(
    player_fns: Dict[str, Any],
    cfg,
    is_continuous: bool,
    device,
    normalize_fn: Optional[Callable] = None,
) -> EvalPolicy:
    """One batched greedy policy over a dreamer-family player-fns dict.
    ``normalize_fn(obs, cnn_keys, device)`` copies the prepared observation
    to ``device`` and scales its pixels (DV2: /255 − 0.5; default /255)."""
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import normalize_obs, prepare_obs

    if normalize_fn is None:
        normalize_fn = normalize_obs
    cnn_keys = list(cfg.cnn_keys.encoder)
    mlp_keys = list(cfg.mlp_keys.encoder)
    greedy = player_fns["greedy_action"]

    def act(obs, state, generator):
        n = int(np.asarray(next(iter(obs.values()))).shape[0])
        norm = normalize_fn(prepare_obs(obs, cnn_keys, mlp_keys, n), cnn_keys, device)
        actions, state = greedy(state, norm, generator)
        if is_continuous:
            real = np.concatenate([a.cpu().numpy() for a in actions], -1)
        else:
            real = np.stack([a.argmax(dim=-1).cpu().numpy() for a in actions], axis=-1)
        return real, state

    return EvalPolicy(act=act, init_state=player_fns["init_states"])

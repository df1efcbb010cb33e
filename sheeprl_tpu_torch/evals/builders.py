"""Eval-policy builder helpers (counterpart of ``sheeprl_tpu/evals/builders.py``).

The dreamer families share one player-fns contract (``init_states(n)``,
``greedy_action``, ``exploration_action`` over a dict of state tensors with
the rows on axis 0), so their builders collapse onto
:func:`dreamer_eval_policy` and differ in agent construction and pixel
scaling. :func:`serving_params` reads the actor and world model out of a
checkpoint's or a publication's state, in the port's layout or the JAX
package's.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.evals.service import EvalPolicy

__all__ = ["actions_dim_of", "dreamer_eval_policy", "family_of", "serving_params"]

#: parts of the port's training world model that a serving build has not
_TRAINING_ONLY = ("cnn_decoder.", "mlp_decoder.", "reward_model.", "continue_model.")


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
    sample_actions: bool = False,
) -> EvalPolicy:
    """One batched policy over a dreamer-family player-fns dict: greedy, or
    with ``sample_actions`` the exploration step at zero exploration (the
    action sampled from the actor: DreamerV3's).
    ``normalize_fn(obs, cnn_keys, device)`` copies the prepared observation
    to ``device`` and scales its pixels (DV2: /255 − 0.5; default /255).
    ``act(..., gumbel=, action_gumbels=)`` takes the posterior's Gumbel
    noise ``[n, S, D]`` (and with ``sample_actions`` each action head's
    ``[n, dim]``) instead of drawing it from ``generator`` (for parity
    tests)."""
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import normalize_obs, prepare_obs

    if normalize_fn is None:
        normalize_fn = normalize_obs
    cnn_keys = list(cfg.cnn_keys.encoder)
    mlp_keys = list(cfg.mlp_keys.encoder)
    def act(obs, state, generator, gumbel=None, action_gumbels=None):
        n = int(np.asarray(next(iter(obs.values()))).shape[0])
        norm = normalize_fn(prepare_obs(obs, cnn_keys, mlp_keys, n), cnn_keys, device)
        if sample_actions:
            actions, state = player_fns["exploration_action"](
                state, norm, 0.0, generator, gumbel=gumbel, action_gumbels=action_gumbels
            )
        else:
            actions, state = player_fns["greedy_action"](state, norm, generator, gumbel=gumbel)
        if is_continuous:
            real = np.concatenate([a.cpu().numpy() for a in actions], -1)
        else:
            real = np.stack([a.argmax(dim=-1).cpu().numpy() for a in actions], axis=-1)
        return real, state

    return EvalPolicy(act=act, init_state=player_fns["init_states"], device=torch.device(device))


def family_of(algo: str) -> str:
    """``dreamer_v1``, ``dreamer_v2`` or ``dreamer_v3``: the family whose
    player serves ``algo`` (Plan2Explore's phases serve their family's task
    actor)."""
    algo = str(algo)
    for family, p2e in (("dreamer_v3", "p2e_dv3_"), ("dreamer_v2", "p2e_dv2_"), ("dreamer_v1", "p2e_dv1_")):
        if algo == family or algo.startswith(p2e):
            return family
    raise NotImplementedError(f"only the DreamerV1, V2 and V3 families are served by the port, not {algo}")


def serving_params(state: Dict[str, Any], algo: str) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{"world_model", "actor"}`` state dicts of a serving build from a
    checkpoint's (or a publication's) ``state``: the port's layout
    (``state["agent"]`` holds each module's state dict), or the JAX
    package's (``state["agent"]["params"]``, converted after ``algo``'s
    family). The actor is the task actor: ``actor_task`` in a P2E
    exploration checkpoint, ``actor`` in any other."""
    agent = state["agent"]
    if "params" not in agent:
        return {
            "world_model": {
                k: torch.as_tensor(v) for k, v in agent["world_model"].items() if not k.startswith(_TRAINING_ONLY)
            },
            "actor": {k: torch.as_tensor(v) for k, v in agent.get("actor_task", agent.get("actor")).items()},
        }
    from sheeprl_tpu_torch import convert

    family = family_of(algo)
    if "actor_task" in agent["params"]:
        trees, _skipped = getattr(convert, f"convert_{family.replace('dreamer_v', 'p2e_dv')}")(agent["params"])
        return {"world_model": trees["world_model"], "actor": trees["actor_task"]}
    params, _skipped = getattr(convert, f"convert_{family}")(agent["params"])
    return params

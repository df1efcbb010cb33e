"""The eval-policy contract and the helpers a checkpoint load needs
(counterpart of ``EvalPolicy``, ``_probe_spaces`` and ``_policy_version_of``
in ``sheeprl_tpu/evals/service.py``). The episode runner and the registry
are not ported yet."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

__all__ = ["EvalPolicy", "policy_version_of", "probe_spaces"]


@dataclass
class EvalPolicy:
    """A frozen agent as a server sees it.

    ``act(obs, state, generator) -> (real_actions, new_state)``: ``obs`` is a
    batched observation dict of numpy arrays (leading axis = rows),
    ``real_actions`` a numpy array, ``state`` the family's recurrent state
    for the rows (None for stateless families) and ``generator`` the
    ``torch.Generator`` the step draws its noise from. ``init_state(n)``
    builds fresh state for ``n`` rows (None for stateless families).
    """

    act: Callable[[Dict[str, np.ndarray], Any, Any], Tuple[np.ndarray, Any]]
    init_state: Optional[Callable[[int], Any]] = None


def probe_spaces(cfg):
    """``(observation_space, action_space)`` of one throwaway env built as
    training builds them (no log dir: the probe never records video)."""
    from sheeprl_tpu_torch.envs.vector import make_eval_env

    env = make_eval_env(cfg, None)
    try:
        return env.observation_space, env.action_space
    finally:
        env.close()


def policy_version_of(checkpoint: Optional[str]) -> Optional[int]:
    """The checkpoint's training step from its manifest, if resolvable."""
    if not checkpoint:
        return None
    from sheeprl_tpu_torch.ckpt.manifest import CheckpointCorruptedError, read_manifest

    try:
        step = read_manifest(str(checkpoint)).get("step")
    except (OSError, CheckpointCorruptedError):
        return None
    return int(step) if step is not None else None

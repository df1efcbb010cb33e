"""The eval-policy contract (counterpart of ``EvalPolicy`` in
``sheeprl_tpu/evals/service.py``). The episode runner, the registry and the
checkpoint loads are not ported yet."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

__all__ = ["EvalPolicy"]


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

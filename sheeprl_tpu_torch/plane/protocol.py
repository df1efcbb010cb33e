"""The actor–learner plane's shared arithmetic (counterpart of
``sheeprl_tpu/plane/protocol.py``): burst segmentation and the policy
versions.

Player and learner exchange no control messages about which updates a
burst covers or which policy version acting at update ``u`` needs: both
derive them from these functions and the same config scalars, which is
what makes a seeded 1-player process run bitwise the thread run.

``version`` counts the updates trained through in this run: version 0 is
the initial (or resumed) parameters, published before any player starts;
after training through update ``t`` the learner publishes ``t −
first_train_update + 1``, where ``first_train_update = max(learning_starts,
start_step)``. Acting at update ``first`` needs the parameters trained
through update ``first − 2``: the learner trains ``u − 1`` while the players
collect ``u`` (plus ``plane.max_policy_lag`` versions of slack).
"""

from __future__ import annotations

from typing import Tuple

__all__ = ["burst_plan", "required_version", "train_gated_burst_plan", "version_after"]


def burst_plan(first: int, act_burst: int, learning_starts: int, num_updates: int) -> Tuple[int, bool]:
    """``(n_act, random_phase)`` for the burst starting at update ``first``:
    a burst crosses neither ``learning_starts`` (so the catch-up train runs
    on time) nor ``num_updates``."""
    random_phase = first <= learning_starts
    boundary = min(learning_starts, num_updates) if random_phase else num_updates
    return max(min(int(act_burst), boundary - first + 1), 1), random_phase


def train_gated_burst_plan(first: int, act_burst: int, learning_starts: int, num_updates: int,
                           updates_before_training: int, resuming: bool = False) -> Tuple[int, bool]:
    """``(n_act, random_phase)`` for loops that train on a ``train_every``
    countdown (the Dreamers): a burst may run through the first update at
    which training fires, ``max(first, learning_starts, first +
    updates_before_training − 1)``, never past it; the random prefill (not
    on resume) acts one step at a time."""
    if first <= learning_starts and not resuming:
        return 1, True
    u_train = max(first, learning_starts, first + int(updates_before_training) - 1)
    return max(min(int(act_burst), u_train - first + 1, num_updates - first + 1), 1), False


def version_after(last: int, first_train_update: int) -> int:
    """The version published after training through update ``last`` (0
    before any training)."""
    return max(0, int(last) - int(first_train_update) + 1)


def required_version(first: int, first_train_update: int) -> int:
    """The version acting at update ``first`` needs: trained through ``first − 2``."""
    return version_after(first - 2, first_train_update)

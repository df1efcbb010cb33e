"""Replay sampling strategies (counterpart of
``sheeprl_tpu/replay/strategies.py``), selected by ``replay.strategy``.

A strategy owns a draw's plan, the ``(t_idx, e_idx)`` rows a burst reads;
the buffers keep storage, gathering and the valid window:

- ``uniform``: the buffer's own ``plan_transitions``, its rng stream in the
  same order (``replay.shards=1`` with it is the plain buffer);
- ``prioritize_ends``: an offset drawn uniformly over the age-ordered
  window and clamped to the last valid start, as the episode buffer's
  ``prioritize_ends`` draws a window start, so the newest rows are drawn
  more often;
- ``td_priority``: proportional prioritized replay (Schaul et al., 2016):
  ``P(i) = p_i^α / Σ p^α`` with ``p_i = |td_i| + eps``, importance weights
  ``(N·P(i))^−β`` (normalized by their largest), unseen rows at the running
  largest priority, and :meth:`TDPriorityStrategy.update_priorities`, which
  the training loop calls after each burst with the drawn rows' TD errors.

The formulas and the draws (numpy ``Generator`` calls in the same order)
are the JAX package's, so the same adds and seed give the same plans,
weights and priority tables.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Type

import numpy as np

from sheeprl_tpu_torch.obs.counters import add_replay_priority_updates

__all__ = [
    "PrioritizeEndsStrategy",
    "SamplingStrategy",
    "TDPriorityStrategy",
    "UniformStrategy",
    "get_strategy",
    "make_strategy",
    "register_strategy",
]

_REGISTRY: Dict[str, Type["SamplingStrategy"]] = {}


def register_strategy(name: str):
    """Class decorator: register a strategy under ``name``."""

    def deco(cls: Type["SamplingStrategy"]) -> Type["SamplingStrategy"]:
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def get_strategy(name: str) -> Type["SamplingStrategy"]:
    try:
        return _REGISTRY[str(name)]
    except KeyError:
        raise ValueError(f"Unknown replay sampling strategy {name!r}: must be one of {sorted(_REGISTRY)}") from None


def make_strategy(replay_cfg: Optional[Dict[str, Any]]) -> "SamplingStrategy":
    """The strategy ``cfg.replay`` names (``uniform`` by default)."""
    replay_cfg = replay_cfg or {}
    name = str(replay_cfg.get("strategy", "uniform") or "uniform")
    cls = get_strategy(name)
    if name == "td_priority":
        prio = replay_cfg.get("priority", {}) or {}
        return cls(alpha=float(prio.get("alpha", 0.6)), beta=float(prio.get("beta", 0.4)),
                   eps=float(prio.get("eps", 1e-6)))
    return cls()


def _plan_envs(rng: np.random.Generator, n_envs: int, envs: Optional[Sequence[int]], total: int) -> np.ndarray:
    """The env columns' draw, after the time rows' (``plan_transitions``' order)."""
    if envs is None:
        return rng.integers(0, n_envs, size=total)
    envs_arr = np.asarray(envs, dtype=np.int64)
    return envs_arr[rng.integers(0, len(envs_arr), size=total)]


def _check_plannable(rb, batch_size: int, n_samples: int) -> None:
    if batch_size <= 0 or n_samples <= 0:
        raise ValueError(f"'batch_size' ({batch_size}) and 'n_samples' ({n_samples}) must be both greater than 0")
    if rb.empty or (not rb.full and rb._pos == 0):
        raise ValueError("No sample has been added to the buffer")


_ONE_ROW = ("You want to sample the next observations, but only one sample has been added to the buffer. "
            "Make sure that at least two samples are added.")


class SamplingStrategy:
    """Plans which rows a burst reads; stateless unless prioritized."""

    name = "base"
    #: the loop writes priorities back after each burst (the staging then samples on the caller's thread)
    needs_writeback = False

    def plan(self, rb, batch_size: int, sample_next_obs: bool = False, n_samples: int = 1,
             rng: Optional[np.random.Generator] = None, envs: Optional[Sequence[int]] = None
             ) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def weights(self, rb, normalize: bool = True) -> Optional[np.ndarray]:
        """Importance weights of ``rb``'s last plan (None when unweighted);
        ``normalize=False`` gives the raw ``(N·P)^−β``, for a caller that
        normalizes across shards."""
        return None

    def update_priorities(self, rb, t_idx: np.ndarray, e_idx: np.ndarray, td_errors: np.ndarray) -> None:
        """The priority writeback (a no-op unless prioritized)."""

    def init_priorities(self, rb, t_idx: np.ndarray) -> None:
        """Mark freshly added time rows at the largest priority (a no-op
        unless prioritized)."""


@register_strategy("uniform")
class UniformStrategy(SamplingStrategy):
    """The buffer's own uniform planner."""

    def plan(self, rb, batch_size, sample_next_obs=False, n_samples=1, rng=None, envs=None):
        return rb.plan_transitions(batch_size, sample_next_obs=sample_next_obs, n_samples=n_samples, rng=rng,
                                   envs=envs)


@register_strategy("prioritize_ends")
class PrioritizeEndsStrategy(SamplingStrategy):
    """The episode buffer's end bias over a ring's age-ordered window: an
    offset uniform over ``length`` (the whole window, the successor-less
    newest row included) clamped to ``length − effective`` (``effective`` =
    1, or 2 with ``sample_next_obs``)."""

    def plan(self, rb, batch_size, sample_next_obs=False, n_samples=1, rng=None, envs=None):
        rng = rb._rng if rng is None else rng
        _check_plannable(rb, batch_size, n_samples)
        ordered = rb.age_ordered_time_indices(sample_next_obs=False)
        length = len(ordered)
        upper = length - (2 if sample_next_obs else 1)
        if upper < 0:
            raise RuntimeError(_ONE_ROW)
        total = batch_size * n_samples
        t_idx = ordered[np.minimum(rng.integers(0, length, size=total), upper)]
        e_idx = _plan_envs(rng, rb.n_envs, envs, total)
        rb.observe_sample_ages(t_idx)
        return t_idx, e_idx


@register_strategy("td_priority")
class TDPriorityStrategy(SamplingStrategy):
    """Proportional TD-error prioritization with importance weights. The
    ``[size, n_envs]`` priority table and the running largest priority are
    kept per buffer, so one strategy serves every shard of a
    :class:`~sheeprl_tpu_torch.replay.sharded.ShardedReplay` without the
    shards sharing priorities."""

    needs_writeback = True

    def __init__(self, alpha: float = 0.6, beta: float = 0.4, eps: float = 1e-6):
        if not 0.0 <= alpha:
            raise ValueError(f"'alpha' must be non-negative, got {alpha}")
        if not 0.0 <= beta:
            raise ValueError(f"'beta' must be non-negative, got {beta}")
        if eps <= 0.0:
            raise ValueError(f"'eps' must be positive, got {eps}")
        self.alpha, self.beta, self.eps = float(alpha), float(beta), float(eps)
        # id(rb) -> (rb, priority table, running largest); the buffer's reference pins its id
        self._state: Dict[int, Tuple[Any, np.ndarray, float]] = {}
        # id(rb) -> (t_idx, e_idx, P of the drawn rows, rows plannable) of the last plan
        self._last: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray, int]] = {}

    def _table(self, rb) -> np.ndarray:
        if id(rb) not in self._state:
            self._state[id(rb)] = (rb, np.zeros((rb.buffer_size, rb.n_envs), np.float64), 1.0)
        return self._state[id(rb)][1]

    def _max_prio(self, rb) -> float:
        self._table(rb)
        return self._state[id(rb)][2]

    def plan(self, rb, batch_size, sample_next_obs=False, n_samples=1, rng=None, envs=None):
        rng = rb._rng if rng is None else rng
        _check_plannable(rb, batch_size, n_samples)
        valid = rb.valid_time_indices(sample_next_obs)
        if len(valid) == 0:
            raise RuntimeError(_ONE_ROW)
        env_cols = np.arange(rb.n_envs, dtype=np.int64) if envs is None else np.asarray(envs, dtype=np.int64)
        prio = self._table(rb)[np.ix_(valid, env_cols)]
        prio = np.where(prio > 0.0, prio, self._max_prio(rb))
        scaled = prio.ravel() ** self.alpha
        probs = scaled / scaled.sum()
        total = batch_size * n_samples
        flat = rng.choice(len(probs), size=total, p=probs)
        t_idx = valid[flat // len(env_cols)]
        e_idx = env_cols[flat % len(env_cols)]
        self._last[id(rb)] = (t_idx, e_idx, probs[flat], len(probs))
        rb.observe_sample_ages(t_idx)
        return t_idx, e_idx

    def weights(self, rb, normalize=True):
        last = self._last.get(id(rb))
        if last is None:
            return None
        _, _, p_sel, n_valid = last
        w = (n_valid * p_sel) ** (-self.beta)
        return w / w.max() if normalize else w

    def update_priorities(self, rb, t_idx, e_idx, td_errors):
        t_idx = np.asarray(t_idx, dtype=np.int64).reshape(-1)
        e_idx = np.asarray(e_idx, dtype=np.int64).reshape(-1)
        td = np.abs(np.asarray(td_errors, dtype=np.float64).reshape(-1)) + self.eps
        if not (len(t_idx) == len(e_idx) == len(td)):
            raise ValueError(f"Priority writeback shapes disagree: {len(t_idx)} rows, {len(e_idx)} env columns, "
                             f"{len(td)} td errors")
        self._table(rb)[t_idx, e_idx] = td
        add_replay_priority_updates(len(td))
        rb_ref, table, max_prio = self._state[id(rb)]
        self._state[id(rb)] = (rb_ref, table, max(max_prio, float(td.max())) if len(td) else max_prio)

    def init_priorities(self, rb, t_idx):
        t_idx = np.asarray(t_idx, dtype=np.int64).reshape(-1)
        if len(t_idx):
            self._table(rb)[t_idx, :] = self._max_prio(rb)

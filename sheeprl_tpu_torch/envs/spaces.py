"""Observation and action spaces of the port's own (the subset of
``gymnasium.spaces`` the env loop reads), so the card path needs no
gymnasium.

``sample()`` draws from the space's numpy ``Generator``: the one given as
``seed`` (an int or a ``Generator``), set by :meth:`Space.seed`, or passed
to ``sample(rng=...)``. Draws follow gymnasium's formulas, so a space seeded
like a gymnasium one samples the same values. :func:`batch_space` stacks
``n`` copies for a vector env, as gymnasium's does (a ``Discrete`` becomes a
``MultiDiscrete`` carrying a copy of the single space's generator; a
``MultiDiscrete`` stays one, of shape ``[n, k]``).
"""

from __future__ import annotations

import copy
from typing import Any, Mapping, Optional, Sequence, Union

import numpy as np

__all__ = ["Box", "Dict", "Discrete", "MultiDiscrete", "Space", "batch_space", "from_gymnasium"]

Seed = Union[None, int, np.random.Generator]


class Space:
    """A shape, a dtype and a generator to sample with."""

    def __init__(self, shape: Sequence[int] = (), dtype: Any = None, seed: Seed = None):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = None if dtype is None else np.dtype(dtype)
        self._np_random: Optional[np.random.Generator] = None
        if seed is not None:
            self.seed(seed)

    @property
    def np_random(self) -> np.random.Generator:
        if self._np_random is None:
            self._np_random = np.random.default_rng()
        return self._np_random

    def seed(self, seed: Seed = None) -> None:
        self._np_random = seed if isinstance(seed, np.random.Generator) else np.random.default_rng(seed)

    def sample(self, rng: Optional[np.random.Generator] = None) -> Any:
        raise NotImplementedError


class Box(Space):
    """A box ``[low, high]`` of ``shape`` (bounds broadcast from scalars)."""

    def __init__(self, low, high, shape: Optional[Sequence[int]] = None, dtype: Any = np.float32, seed: Seed = None):
        if shape is None:
            shape = np.broadcast(np.asarray(low), np.asarray(high)).shape
        super().__init__(shape, dtype, seed)
        self.low = np.broadcast_to(np.asarray(low, dtype=self.dtype), self.shape).copy()
        self.high = np.broadcast_to(np.asarray(high, dtype=self.dtype), self.shape).copy()

    def sample(self, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """gymnasium's draw: uniform on a bounded interval, exponential on a
        half-bounded one, normal on an unbounded one; integer boxes floor."""
        rng = self.np_random if rng is None else rng
        high = self.high.astype(np.float64) + 1 if self.dtype.kind == "i" else self.high.astype(np.float64)
        low = self.low.astype(np.float64)
        bounded_below, bounded_above = np.isfinite(low), np.isfinite(high)
        out = np.empty(self.shape)
        unbounded = ~bounded_below & ~bounded_above
        upp = ~bounded_below & bounded_above
        low_b = bounded_below & ~bounded_above
        bounded = bounded_below & bounded_above
        out[unbounded] = rng.normal(size=unbounded[unbounded].shape)
        out[low_b] = rng.exponential(size=low_b[low_b].shape) + low[low_b]
        out[upp] = high[upp] - rng.exponential(size=upp[upp].shape)
        out[bounded] = rng.uniform(low=low[bounded], high=high[bounded], size=bounded[bounded].shape)
        if self.dtype.kind in "iu":
            out = np.floor(out)
        return out.astype(self.dtype)

    def __repr__(self) -> str:
        return f"Box({self.low.min()}, {self.high.max()}, {self.shape}, {self.dtype})"


class Discrete(Space):
    """``{start, ..., start + n - 1}``."""

    def __init__(self, n: int, seed: Seed = None, start: int = 0, dtype: Any = np.int64):
        super().__init__((), dtype, seed)
        self.n = int(n)
        self.start = int(start)

    def sample(self, rng: Optional[np.random.Generator] = None):
        rng = self.np_random if rng is None else rng
        return self.start + rng.integers(self.n, dtype=self.dtype.type)

    def __repr__(self) -> str:
        return f"Discrete({self.n})"


class MultiDiscrete(Space):
    """One ``Discrete`` per entry of ``nvec`` (any shape)."""

    def __init__(self, nvec, dtype: Any = np.int64, seed: Seed = None, start=None):
        nvec = np.asarray(nvec, dtype=dtype)
        super().__init__(nvec.shape, dtype, seed)
        self.nvec = nvec
        self.start = np.zeros_like(nvec) if start is None else np.asarray(start, dtype=dtype)

    def sample(self, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        rng = self.np_random if rng is None else rng
        return (rng.random(self.nvec.shape) * self.nvec).astype(self.dtype) + self.start

    def __repr__(self) -> str:
        return f"MultiDiscrete({self.nvec.tolist()})"


class Dict(Space):
    """A mapping of named spaces."""

    def __init__(self, spaces: Mapping[str, Space], seed: Seed = None):
        super().__init__((), None, None)
        self.spaces: dict = dict(spaces)
        if seed is not None:
            self.seed(seed)

    def seed(self, seed: Seed = None) -> None:
        super().seed(seed)
        for i, space in enumerate(self.spaces.values()):
            space.seed(None if seed is None else (seed if isinstance(seed, np.random.Generator) else seed + i))

    def sample(self, rng: Optional[np.random.Generator] = None) -> dict:
        return {k: s.sample(rng) for k, s in self.spaces.items()}

    def __getitem__(self, key: str) -> Space:
        return self.spaces[key]

    def __setitem__(self, key: str, space: Space) -> None:
        self.spaces[key] = space

    def __contains__(self, key: str) -> bool:
        return key in self.spaces

    def keys(self):
        return self.spaces.keys()

    def items(self):
        return self.spaces.items()

    def __repr__(self) -> str:
        return "Dict(" + ", ".join(f"{k!r}: {v}" for k, v in self.spaces.items()) + ")"


def batch_space(space: Space, n: int) -> Space:
    """``n`` stacked copies of ``space``, sampling with a copy of its generator."""
    rng = copy.deepcopy(space.np_random)
    if isinstance(space, Discrete):
        return MultiDiscrete(np.full((n,), space.n), dtype=space.dtype, seed=rng, start=np.full((n,), space.start))
    if isinstance(space, MultiDiscrete):
        reps = (n,) + (1,) * space.nvec.ndim
        return MultiDiscrete(np.tile(space.nvec, reps), dtype=space.dtype, seed=rng, start=np.tile(space.start, reps))
    if isinstance(space, Box):
        reps = (n,) + (1,) * len(space.shape)
        return Box(np.tile(space.low, reps), np.tile(space.high, reps), dtype=space.dtype, seed=rng)
    if isinstance(space, Dict):
        return Dict({k: batch_space(s, n) for k, s in space.items()})
    raise TypeError(f"cannot batch a {type(space).__name__}")


def from_gymnasium(space) -> Space:
    """The port's space for a ``gymnasium.spaces`` one (read by attribute, so
    gymnasium is not imported here)."""
    kind = type(space).__name__
    if kind == "Dict":
        return Dict({k: from_gymnasium(s) for k, s in space.spaces.items()})
    if kind == "Box":
        return Box(space.low, space.high, space.shape, space.dtype)
    if kind == "Discrete":
        return Discrete(int(space.n), start=int(space.start), dtype=space.dtype)
    if kind == "MultiDiscrete":
        return MultiDiscrete(space.nvec, dtype=space.dtype, start=space.start)
    raise NotImplementedError(f"the port has no counterpart of the gymnasium space {kind}")

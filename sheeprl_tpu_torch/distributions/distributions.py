"""Distributions of the Dreamer slices (counterpart of ``symlog``/``symexp``,
``Normal``, ``Independent``, ``Bernoulli``, the categorical family,
``kl_divergence`` and DreamerV3's ``SymlogDistribution``,
``MSEDistribution`` and ``TwoHotEncodingDistribution`` in
``sheeprl_tpu/distributions/distributions.py``).

A categorical sample is ``one_hot(argmax(logits + gumbel))``, the form
``jax.random.categorical`` takes, so a test can hand both sides the same
Gumbel noise. The noise comes from an explicit ``torch.Generator`` or is
passed in.

These are the port's own classes, not ``torch.distributions``: the
continue head's targets are ``(1 - done)·γ`` (0.995 for MsPacman), which
``torch.distributions.Bernoulli`` rejects as a sample under its default
argument validation; the JAX ``Bernoulli`` takes soft targets, and so does
this one.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = [
    "Bernoulli",
    "Independent",
    "MSEDistribution",
    "Normal",
    "OneHotCategorical",
    "OneHotCategoricalStraightThrough",
    "SymlogDistribution",
    "TwoHotEncodingDistribution",
    "gumbel_noise",
    "kl_divergence",
    "symexp",
    "symlog",
]

_HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)


def symlog(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


def gumbel_noise(
    shape, generator: Optional[torch.Generator] = None, device=None, dtype=torch.float32
) -> torch.Tensor:
    """Gumbel(0, 1) noise ``-log(-log(u))``, ``u`` uniform in (0, 1)."""
    tiny = torch.finfo(dtype).tiny
    u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    return -torch.log(-torch.log(u.clamp(min=tiny, max=1.0 - torch.finfo(dtype).eps)))


class OneHotCategorical:
    """One-hot categorical over the last axis; ``logits`` are normalized."""

    def __init__(self, logits: Optional[torch.Tensor] = None, probs: Optional[torch.Tensor] = None):
        if (logits is None) == (probs is None):
            raise ValueError("Provide exactly one of logits / probs")
        if logits is None:
            probs = probs / probs.sum(dim=-1, keepdim=True)
            logits = torch.log(probs.clamp(min=1e-12))
        self.logits = F.log_softmax(logits, dim=-1)

    @property
    def probs(self) -> torch.Tensor:
        return torch.exp(self.logits)

    @property
    def num_classes(self) -> int:
        return self.logits.shape[-1]

    @property
    def mean(self) -> torch.Tensor:
        return self.probs

    @property
    def mode(self) -> torch.Tensor:
        idx = self.logits.argmax(dim=-1)
        return F.one_hot(idx, self.num_classes).to(self.logits.dtype)

    def sample(
        self, generator: Optional[torch.Generator] = None, gumbel: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        if gumbel is None:
            gumbel = gumbel_noise(
                self.logits.shape, generator, device=self.logits.device, dtype=self.logits.dtype
            )
        idx = (self.logits + gumbel).argmax(dim=-1)
        return F.one_hot(idx, self.num_classes).to(self.logits.dtype)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        return (value * self.logits).sum(dim=-1)

    def entropy(self) -> torch.Tensor:
        return -(self.probs * self.logits).sum(dim=-1)


class OneHotCategoricalStraightThrough(OneHotCategorical):
    """``rsample = sample + probs − probs.detach()`` (straight-through)."""

    def rsample(
        self, generator: Optional[torch.Generator] = None, gumbel: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        s = self.sample(generator, gumbel)
        probs = self.probs
        return s + probs - probs.detach()


class Normal:
    """Gaussian with ``loc`` and ``scale`` (a tensor or a float; a float
    stays on the host, so that no copy to the device is made, which a CUDA
    graph capture refuses)."""

    def __init__(self, loc: torch.Tensor, scale):
        self.loc = loc
        self.scale = scale if isinstance(scale, torch.Tensor) else float(scale)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        var = self.scale**2
        log_scale = torch.log(self.scale) if isinstance(self.scale, torch.Tensor) else math.log(self.scale)
        return -((value - self.loc) ** 2) / (2 * var) - log_scale - _HALF_LOG_2PI


class Bernoulli:
    """Independent Bernoulli with logits; ``log_prob`` takes soft targets in
    [0, 1] (the Dreamer continue head regresses ``(1 - done)·γ``)."""

    def __init__(self, logits: torch.Tensor):
        self.logits = logits

    @property
    def mode(self) -> torch.Tensor:
        return (self.logits > 0).to(self.logits.dtype)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        return -(F.softplus(-self.logits) * value + F.softplus(self.logits) * (1.0 - value))


class Independent:
    """Sums ``log_prob`` and ``entropy`` over the last ``reinterpreted_batch_ndims`` dims."""

    def __init__(self, base, reinterpreted_batch_ndims: int = 1):
        self.base = base
        self.ndims = int(reinterpreted_batch_ndims)

    def _reduce(self, x: torch.Tensor) -> torch.Tensor:
        return x.sum(dim=tuple(range(-self.ndims, 0))) if self.ndims else x

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        return self._reduce(self.base.log_prob(value))

    def entropy(self) -> torch.Tensor:
        return self._reduce(self.base.entropy())


def kl_divergence(p, q) -> torch.Tensor:
    """KL(p ‖ q) for one-hot categoricals, optionally under matching
    :class:`Independent` wrappers (the Dreamer KL balance)."""
    if isinstance(p, Independent) and isinstance(q, Independent):
        if p.ndims != q.ndims:
            raise ValueError("Independent KL requires matching reinterpreted dims")
        inner = kl_divergence(p.base, q.base)
        return inner.sum(dim=tuple(range(-p.ndims, 0))) if p.ndims else inner
    if isinstance(p, OneHotCategorical) and isinstance(q, OneHotCategorical):
        return (torch.exp(p.logits) * (p.logits - q.logits)).sum(dim=-1)
    raise NotImplementedError(f"KL not implemented for {type(p).__name__} / {type(q).__name__}")


def _sum_last(x: torch.Tensor, dims: int, agg: str = "sum") -> torch.Tensor:
    axes = tuple(range(-dims, 0))
    return x.sum(dim=axes) if agg == "sum" else x.mean(dim=axes)


class SymlogDistribution:
    """``log_prob`` is minus the squared (``dist="mse"``) or absolute error in
    symlog space, summed (or averaged) over the last ``dims`` axes; the mode
    is ``symexp`` of the prediction. The DreamerV3 vector decoder's head."""

    def __init__(self, mode: torch.Tensor, dims: int = 1, dist: str = "mse", agg: str = "sum"):
        if dist not in ("mse", "abs"):
            raise ValueError(f"Unknown distance '{dist}'")
        self._mode, self._dims, self._dist, self._agg = mode, int(dims), dist, agg

    @property
    def mode(self) -> torch.Tensor:
        return symexp(self._mode)

    mean = mode

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        diff = self._mode - symlog(value)
        distance = diff.square() if self._dist == "mse" else diff.abs()
        return -_sum_last(distance, self._dims, self._agg)


class MSEDistribution:
    """``log_prob`` is minus the squared error over the last ``dims`` axes:
    the DreamerV3 pixel decoder's head."""

    def __init__(self, mode: torch.Tensor, dims: int = 3, agg: str = "sum"):
        self._mode, self._dims, self._agg = mode, int(dims), agg

    @property
    def mode(self) -> torch.Tensor:
        return self._mode

    mean = mode

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        return -_sum_last((self._mode - value).square(), self._dims, self._agg)


class TwoHotEncodingDistribution:
    """``n`` bins uniform in symlog space on ``[low, high]`` (DreamerV3's
    reward head and critic, 255 bins on ±20). ``mean`` and ``mode`` are
    ``symexp`` of the expected bin, ``[..., 1]``; ``log_prob`` of a value
    ``[..., 1]`` is the cross-entropy against the two-hot encoding of its
    symlog, summed over the last ``dims`` axes.

    The encoding is the JAX package's index arithmetic, not a search:
    ``pos = (clip(x) − low) / step``, ``above = clip(ceil(pos), 1, n−1)``,
    ``below = above − 1``, the weight on ``above`` ``clip(pos − below, 0,
    1)``. At a value on a bin ``k ≥ 1`` the whole weight sits on ``k`` as
    the upper bin; at ``low`` on bin 0 as the lower one."""

    def __init__(self, logits: torch.Tensor, dims: int = 1, low: float = -20.0, high: float = 20.0):
        n = logits.shape[-1]
        if n < 2:
            raise ValueError(
                f"TwoHotEncodingDistribution needs at least 2 bins to place probability mass between bin edges, got {n}"
            )
        self.logits = logits
        self._dims = int(dims)
        self._low, self._high = float(low), float(high)
        self._step = (self._high - self._low) / (n - 1)
        self.bins = torch.linspace(self._low, self._high, n, dtype=logits.dtype, device=logits.device)

    @property
    def probs(self) -> torch.Tensor:
        return F.softmax(self.logits, dim=-1)

    @property
    def mean(self) -> torch.Tensor:
        return symexp((self.probs * self.bins).sum(dim=-1, keepdim=True))

    mode = mean

    def two_hot(self, x: torch.Tensor) -> torch.Tensor:
        """The two-hot target ``[..., n]`` of symlog-space values ``x [...]``."""
        n = self.logits.shape[-1]
        pos = (x.clamp(self._low, self._high) - self._low) / self._step
        above = torch.ceil(pos).to(torch.long).clamp(1, n - 1)
        below = above - 1
        w_above = (pos - below.to(x.dtype)).clamp(0.0, 1.0)
        return F.one_hot(below, n).to(x.dtype) * (1.0 - w_above)[..., None] + F.one_hot(above, n).to(
            x.dtype
        ) * w_above[..., None]

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        target = self.two_hot(symlog(value)[..., 0])
        ll = (target * F.log_softmax(self.logits, dim=-1)).sum(dim=-1, keepdim=True)
        return _sum_last(ll, self._dims) if self._dims else ll

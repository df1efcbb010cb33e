"""Distributions of the DreamerV2 slice (counterpart of ``Normal``,
``Independent``, ``Bernoulli``, the categorical family and ``kl_divergence``
in ``sheeprl_tpu/distributions/distributions.py``).

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
    "Normal",
    "OneHotCategorical",
    "OneHotCategoricalStraightThrough",
    "gumbel_noise",
    "kl_divergence",
]

_HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)


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
    """Gaussian with ``loc`` and ``scale`` (tensors or floats)."""

    def __init__(self, loc: torch.Tensor, scale):
        self.loc = loc
        self.scale = torch.as_tensor(scale, dtype=loc.dtype, device=loc.device)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        var = self.scale**2
        return -((value - self.loc) ** 2) / (2 * var) - torch.log(self.scale) - _HALF_LOG_2PI


class Bernoulli:
    """Independent Bernoulli with logits; ``log_prob`` takes soft targets in
    [0, 1] (the Dreamer continue head regresses ``(1 - done)·γ``)."""

    def __init__(self, logits: torch.Tensor):
        self.logits = logits

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

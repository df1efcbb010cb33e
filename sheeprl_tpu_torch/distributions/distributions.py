"""Distributions of the Dreamer slices (counterpart of ``symlog``/``symexp``,
``Normal``, ``TanhNormal``, ``TruncatedNormal``, ``Independent``,
``Bernoulli``, the categorical family, ``kl_divergence`` and DreamerV3's
``SymlogDistribution``, ``MSEDistribution`` and
``TwoHotEncodingDistribution`` in ``sheeprl_tpu/distributions/distributions.py``).

A categorical sample is ``one_hot(argmax(logits + gumbel))``, the form
``jax.random.categorical`` takes, so a test can hand both sides the same
Gumbel noise. A continuous sample is a function of its base noise, drawn by
``draw_noise`` or passed in: a standard normal for ``Normal`` and
``TanhNormal`` (``loc + scale·ε``), a uniform on ``[1e-6, 1 − 1e-6]`` for
``TruncatedNormal`` (its inverse cdf, then clipped to the bounds), as the
JAX samplers draw it. The noise comes from an explicit ``torch.Generator``
or is passed in.

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
    "TanhNormal",
    "TruncatedNormal",
    "TwoHotEncodingDistribution",
    "gumbel_noise",
    "kl_divergence",
    "symexp",
    "symlog",
    "truncated_uniform_noise",
]

_HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)
_LOG_2 = math.log(2.0)
_SQRT_2 = math.sqrt(2.0)


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


def _noise_shape(sample_shape, *params) -> tuple:
    shapes = (p.shape for p in params if isinstance(p, torch.Tensor))
    return tuple(sample_shape) + tuple(torch.broadcast_shapes(*shapes))


class Normal:
    """Gaussian with ``loc`` and ``scale`` (a tensor or a float; a float
    stays on the host, so that no copy to the device is made, which a CUDA
    graph capture refuses). Its base noise is a standard normal ``ε``:
    ``rsample = loc + scale·ε``."""

    def __init__(self, loc: torch.Tensor, scale):
        self.loc = loc
        self.scale = scale if isinstance(scale, torch.Tensor) else float(scale)

    @property
    def mean(self) -> torch.Tensor:
        return self.loc

    @property
    def mode(self) -> torch.Tensor:
        return self.loc

    @property
    def stddev(self):
        return self.scale

    def draw_noise(self, sample_shape=(), generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Standard normal noise of shape ``sample_shape + batch shape``."""
        return torch.randn(_noise_shape(sample_shape, self.loc, self.scale), generator=generator,
                           device=self.loc.device, dtype=self.loc.dtype)

    def rsample(self, sample_shape=(), generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        if noise is None:
            noise = self.draw_noise(sample_shape, generator)
        return self.loc + self.scale * noise

    def sample(self, sample_shape=(), generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.rsample(sample_shape, generator, noise).detach()

    def _log_scale(self):
        return torch.log(self.scale) if isinstance(self.scale, torch.Tensor) else math.log(self.scale)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        var = self.scale**2
        return -((value - self.loc) ** 2) / (2 * var) - self._log_scale() - _HALF_LOG_2PI

    def entropy(self) -> torch.Tensor:
        return torch.zeros_like(self.loc) + (0.5 + _HALF_LOG_2PI + self._log_scale())


class TanhNormal:
    """A tanh-squashed :class:`Normal`. ``log_prob`` subtracts the
    log-determinant in the stable form ``2·(log 2 − u − softplus(−2u))`` at
    ``u = atanh(clip(value, −1 + 1e-6, 1 − 1e-6))``. It has no closed-form
    entropy (the Dreamer actors report zeros for it)."""

    def __init__(self, loc: torch.Tensor, scale):
        self.base = Normal(loc, scale)

    @property
    def mean(self) -> torch.Tensor:
        return torch.tanh(self.base.mean)

    @property
    def mode(self) -> torch.Tensor:
        return torch.tanh(self.base.mode)

    def rsample(self, sample_shape=(), generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        return torch.tanh(self.base.rsample(sample_shape, generator, noise))

    def sample(self, sample_shape=(), generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.rsample(sample_shape, generator, noise).detach()

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        u = torch.atanh(value.clamp(-1.0 + 1e-6, 1.0 - 1e-6))
        return self.base.log_prob(u) - 2.0 * (_LOG_2 - u - F.softplus(-2.0 * u))


def _std_normal_cdf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1 + torch.erf(x / _SQRT_2))


def _std_normal_icdf(p: torch.Tensor) -> torch.Tensor:
    return _SQRT_2 * torch.erfinv(2 * p - 1)


def _std_normal_pdf(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(-0.5 * x * x) / math.sqrt(2 * math.pi)


def truncated_uniform_noise(
    shape, generator: Optional[torch.Generator] = None, device=None, dtype=torch.float32
) -> torch.Tensor:
    """Uniforms on ``[1e-6, 1 − 1e-6]``, where a truncated normal's inverse
    cdf is drawn (JAX's ``uniform(minval=1e-6, maxval=1 - 1e-6)``)."""
    u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    return 1e-6 + (1.0 - 2e-6) * u


class TruncatedNormal:
    """``Normal(loc, scale)`` truncated to ``[low, high]`` (floats): analytic
    ``cdf``, ``icdf``, ``mean``, ``log_prob`` (−inf outside the bounds) and
    ``entropy``; ``Z = Φ(β) − Φ(α)`` clipped at 1e-8. Its base noise is a
    uniform ``p`` on ``[1e-6, 1 − 1e-6]``: ``rsample = clip(icdf(p), low,
    high)``, differentiable in ``loc`` and ``scale``. The Dreamer
    continuous actors' distribution."""

    def __init__(self, loc: torch.Tensor, scale: torch.Tensor, low: float = -1.0, high: float = 1.0):
        self.loc, self.scale = loc, scale
        self.low, self.high = float(low), float(high)
        self.alpha = (self.low - loc) / scale
        self.beta = (self.high - loc) / scale
        self.cdf_alpha = _std_normal_cdf(self.alpha)
        self.Z = (_std_normal_cdf(self.beta) - self.cdf_alpha).clamp(min=1e-8)

    @property
    def mean(self) -> torch.Tensor:
        return self.loc + self.scale * (_std_normal_pdf(self.alpha) - _std_normal_pdf(self.beta)) / self.Z

    @property
    def mode(self) -> torch.Tensor:
        return self.loc.clamp(self.low, self.high)

    def cdf(self, value: torch.Tensor) -> torch.Tensor:
        xi = (value - self.loc) / self.scale
        return ((_std_normal_cdf(xi) - self.cdf_alpha) / self.Z).clamp(0.0, 1.0)

    def icdf(self, p: torch.Tensor) -> torch.Tensor:
        return self.loc + self.scale * _std_normal_icdf(self.cdf_alpha + p * self.Z)

    def draw_noise(self, sample_shape=(), generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """:func:`truncated_uniform_noise` of shape ``sample_shape + batch shape``."""
        return truncated_uniform_noise(_noise_shape(sample_shape, self.loc, self.scale), generator,
                                       self.loc.device, self.loc.dtype)

    def rsample(self, sample_shape=(), generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        if noise is None:
            noise = self.draw_noise(sample_shape, generator)
        return self.icdf(noise).clamp(self.low, self.high)

    def sample(self, sample_shape=(), generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.rsample(sample_shape, generator, noise).detach()

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        xi = (value - self.loc) / self.scale
        log_p = -0.5 * xi * xi - _HALF_LOG_2PI - torch.log(self.scale) - torch.log(self.Z)
        inside = (value >= self.low) & (value <= self.high)
        return torch.where(inside, log_p, torch.full_like(log_p, -math.inf))

    def entropy(self) -> torch.Tensor:
        # lim x→±inf x·pdf(x) = 0
        a_term = torch.where(torch.isfinite(self.alpha), self.alpha * _std_normal_pdf(self.alpha), 0.0)
        b_term = torch.where(torch.isfinite(self.beta), self.beta * _std_normal_pdf(self.beta), 0.0)
        return 0.5 + _HALF_LOG_2PI + torch.log(self.scale * self.Z) + (a_term - b_term) / (2 * self.Z)


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
    """Sums ``log_prob`` and ``entropy`` over the last ``reinterpreted_batch_ndims`` dims;
    means, modes and samples are the base's."""

    def __init__(self, base, reinterpreted_batch_ndims: int = 1):
        self.base = base
        self.ndims = int(reinterpreted_batch_ndims)

    def _reduce(self, x: torch.Tensor) -> torch.Tensor:
        return x.sum(dim=tuple(range(-self.ndims, 0))) if self.ndims else x

    @property
    def mean(self) -> torch.Tensor:
        return self.base.mean

    @property
    def mode(self) -> torch.Tensor:
        return self.base.mode

    def rsample(self, sample_shape=(), generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.base.rsample(sample_shape, generator, noise)

    def sample(self, sample_shape=(), generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.base.sample(sample_shape, generator, noise)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        return self._reduce(self.base.log_prob(value))

    def entropy(self) -> torch.Tensor:
        return self._reduce(self.base.entropy())


def kl_divergence(p, q) -> torch.Tensor:
    """KL(p ‖ q) for one-hot categoricals (the Dreamer KL balance) or for
    Gaussians (DreamerV1's latents), optionally under matching
    :class:`Independent` wrappers."""
    if isinstance(p, Independent) and isinstance(q, Independent):
        if p.ndims != q.ndims:
            raise ValueError("Independent KL requires matching reinterpreted dims")
        inner = kl_divergence(p.base, q.base)
        return inner.sum(dim=tuple(range(-p.ndims, 0))) if p.ndims else inner
    if isinstance(p, OneHotCategorical) and isinstance(q, OneHotCategorical):
        return (torch.exp(p.logits) * (p.logits - q.logits)).sum(dim=-1)
    if isinstance(p, Normal) and isinstance(q, Normal):
        var_ratio = (p.scale / q.scale) ** 2
        t1 = ((p.loc - q.loc) / q.scale) ** 2
        return 0.5 * (var_ratio + t1 - 1 - torch.log(var_ratio))
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

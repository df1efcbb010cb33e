"""One-hot categorical distributions (counterpart of the categorical family in
``sheeprl_tpu/distributions/distributions.py``).

A sample is ``one_hot(argmax(logits + gumbel))``, the form
``jax.random.categorical`` takes, so a test can hand both sides the same
Gumbel noise. The noise comes from an explicit ``torch.Generator`` or is
passed in.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["OneHotCategorical", "OneHotCategoricalStraightThrough", "gumbel_noise"]


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

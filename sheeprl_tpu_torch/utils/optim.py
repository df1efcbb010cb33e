"""Optimizers (counterpart of ``sheeprl_tpu/utils/optim.py``).

The JAX factory ``Adam(lr, betas, eps, weight_decay, max_grad_norm)`` is
``optax.adamw`` when ``weight_decay`` is set (decoupled decay:
``p ← p − lr·(adam_direction + wd·p)``), else ``optax.adam``, chained after
``optax.clip_by_global_norm``. Here :class:`Adam` is the port's own
optimizer in optax's order of operations (``torch.optim.Adam``'s decay is an
L2 term added to the gradient, and ``torch.optim.AdamW`` scales the
parameter before the Adam step), and the clip is the optax form
``g · c / max(‖g‖, c)``: ``torch.nn.utils.clip_grad_norm_`` divides by
``‖g‖ + 1e-6`` instead.

:class:`Adam` is made to be replayed from a CUDA graph: its state is
allocated when it is built and updated in place, the step count is a tensor
on the parameters' device (the bias corrections are computed there), and a
step is a handful of ``foreach`` kernels with no host synchronisation. It
runs the same on the CPU. Its ``state_dict`` keeps ``torch.optim.Adam``'s
layout (``step``, ``exp_avg``, ``exp_avg_sq`` per parameter index), so
checkpoints written with ``torch.optim.AdamW`` load into it.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Sequence

import torch

__all__ = ["Adam", "clip_by_global_norm_", "global_norm"]


class Adam(torch.optim.Optimizer):
    """``optax.adamw`` (``weight_decay`` > 0) or ``optax.adam``, per element:
    ``m ← (1−b1)·g + b1·m``, ``v ← (1−b2)·g² + b2·v``, ``n ← n + 1``,
    ``u = (m / (1 − b1ⁿ)) / (sqrt(v / (1 − b2ⁿ)) + eps)``, ``u ← u + wd·p``,
    ``p ← p + (−lr)·u``. Every parameter must have a gradient when
    :meth:`step` runs (the train step gives the ones its loss did not reach
    a zero gradient, as JAX does)."""

    def __init__(
        self,
        params: Iterable[torch.nn.Parameter],
        lr: float = 1e-3,
        betas: Sequence[float] = (0.9, 0.999),
        eps: float = 1e-8,
        weight_decay: float = 0.0,
    ):
        b1, b2 = betas
        super().__init__(params, dict(lr=float(lr), betas=(float(b1), float(b2)), eps=float(eps),
                                      weight_decay=float(weight_decay)))
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p] = {
                    "step": torch.zeros((), dtype=torch.float32, device=p.device),
                    "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                    "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format),
                }

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adam.step takes no closure")
        for group in self.param_groups:
            params = group["params"]
            if not params:
                continue
            b1, b2 = group["betas"]
            state = [self.state[p] for p in params]
            grads = [p.grad for p in params]
            m = [s["exp_avg"] for s in state]
            v = [s["exp_avg_sq"] for s in state]
            torch._foreach_add_([s["step"] for s in state], 1.0)
            count = state[0]["step"]  # every parameter's count is the same
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, torch._foreach_mul(grads, 1.0 - b1))
            torch._foreach_mul_(v, b2)
            torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2))
            bc1 = 1.0 - torch.pow(b1, count)
            bc2 = 1.0 - torch.pow(b2, count)
            denom = torch._foreach_sqrt(torch._foreach_div(v, bc2))
            torch._foreach_add_(denom, group["eps"])
            update = torch._foreach_div(torch._foreach_div(m, bc1), denom)
            if group["weight_decay"]:
                torch._foreach_add_(update, torch._foreach_mul(params, group["weight_decay"]))
            torch._foreach_mul_(update, -group["lr"])
            torch._foreach_add_(params, update)

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        """Copy a ``state_dict``'s per-parameter state into this optimizer's
        own tensors, in place (a captured graph keeps reading them); the
        hyperparameters stay the ones it was built with."""
        params = [p for group in self.param_groups for p in group["params"]]
        saved = state_dict["state"]
        if len(saved) != len(params):
            raise ValueError(f"the state holds {len(saved)} parameters, the optimizer {len(params)}")
        for i, p in enumerate(params):
            entry = saved[i] if i in saved else saved[str(i)]
            for key, target in self.state[p].items():
                target.copy_(torch.as_tensor(entry[key]).reshape(target.shape))


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every element of every tensor (``optax.global_norm``)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def clip_by_global_norm_(tensors: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: each ``t`` becomes
    ``t / ‖g‖ · max_norm`` when ``‖g‖ ≥ max_norm``. Returns the norm before
    clipping, as a device tensor (no host synchronisation)."""
    norm = global_norm(tensors)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(list(tensors), scale)
    return norm

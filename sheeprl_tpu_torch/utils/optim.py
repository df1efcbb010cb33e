"""Optimizers (counterpart of ``sheeprl_tpu/utils/optim.py``).

The JAX factory ``Adam(lr, betas, eps, weight_decay, max_grad_norm)`` is
``optax.adamw`` when ``weight_decay`` is set (decoupled decay:
``p ← p − lr·(adam_direction + wd·p)``), else ``optax.adam``, chained after
``optax.clip_by_global_norm``; ``AdamW`` is ``optax.adamw`` always (its
default decay 1e-2, the JAX factory's) and ``SGD`` is ``optax.sgd``
(``add_decayed_weights`` before it when ``weight_decay`` is set), each under
``optax.inject_hyperparams`` so that the learning rate can change between
updates (``set_lr``). Here :class:`Adam` is the port's own
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

Each optimizer keeps its learning rate in a device scalar
(``optimizer.lr``, on its parameters' device) that a step reads, so that
:func:`set_lr` anneals it between replays of a captured step without
capturing it again (``u·lr`` then ``p − u·lr`` is the same float32 as
optax's ``p + u·(−lr)``). The global-norm clip is
:func:`clip_by_global_norm_`, applied to the gradients before the step, as
the JAX chain applies it.

With ``track_updates`` on (the learn probes turn it on, ``obs/learn``) a
step also writes ‖lr·u‖², the squared norm of the update it applied, into
the device scalar ``optimizer.update_sq``: no parameter copy, no host
synchronisation. Off, a step is exactly what it was.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence

import torch

__all__ = ["SGD", "Adam", "AdamW", "clip_by_global_norm_", "global_norm", "set_lr", "square_norms", "square_sums"]


def _device_lr(optimizer: torch.optim.Optimizer, lr: float) -> torch.Tensor:
    params = [p for group in optimizer.param_groups for p in group["params"]]
    return torch.tensor(float(lr), dtype=torch.float32, device=params[0].device if params else None)


def _apply_lr(optimizer: torch.optim.Optimizer, params, update) -> None:
    """``p ← p + (−lr)·u`` (optax's ``scale_by_learning_rate``, then
    ``apply_updates``), by the optimizer's device scalar ``lr``; with
    ``track_updates``, ‖lr·u‖² into ``update_sq``."""
    torch._foreach_mul_(update, optimizer.lr)
    if optimizer.track_updates:
        optimizer.update_sq.copy_(square_norms(update).sum())
    torch._foreach_sub_(params, update)


def _track_state(optimizer: torch.optim.Optimizer) -> None:
    optimizer.track_updates = False
    optimizer.update_sq = torch.zeros((), dtype=torch.float32, device=optimizer.lr.device)


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
        self.lr = _device_lr(self, lr)
        _track_state(self)
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p] = {
                    "step": torch.zeros((), dtype=torch.float32, device=p.device),
                    "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                    "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format),
                }

    @torch.no_grad()
    def step(self, closure=None, gate: Optional[torch.Tensor] = None):
        """One update; with ``gate`` (a bool device scalar) the parameters and
        the state take it only where the gate is on and keep their values
        otherwise (the JAX steps' ``where(do_update, new, old)`` on both
        trees), with no host branch. ``update_sq`` is the update computed,
        gated or not, as the JAX steps hand their probes the updates
        ``tx.update`` returned."""
        if closure is not None:
            raise ValueError("Adam.step takes no closure")
        if gate is not None:
            tensors = [t for group in self.param_groups for p in group["params"]
                       for t in (p, *self.state[p].values())]
            before = [t.clone() for t in tensors]
            self.step()
            for t, old in zip(tensors, before):
                t.copy_(torch.where(gate, t, old))
            return
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
            _apply_lr(self, params, update)

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


class AdamW(Adam):
    """The JAX factory's ``AdamW``: ``optax.adamw``, weight decay 1e-2 by default."""

    def __init__(self, params, lr: float = 1e-3, betas: Sequence[float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-2):
        super().__init__(params, lr=lr, betas=betas, eps=eps, weight_decay=weight_decay)


class SGD(torch.optim.Optimizer):
    """The JAX factory's ``SGD``: ``g ← g + wd·p`` when ``weight_decay`` is
    set (``optax.add_decayed_weights``), then with ``momentum`` optax's
    ``trace``: ``t ← g + momentum·t`` and ``u = t`` (``u = g + momentum·t``
    with ``nesterov``), else ``u = g``; ``p ← p + (−lr)·u``. The trace starts
    at zero, which is ``torch.optim.SGD``'s first step at ``dampening=0``;
    another dampening has no optax counterpart and raises. Replayable from a
    CUDA graph as :class:`Adam` is; the state (``momentum_buffer``) is
    allocated when it is built."""

    def __init__(self, params, lr: float = 1e-2, momentum: float = 0.0, weight_decay: float = 0.0,
                 nesterov: bool = False, dampening: float = 0.0):
        if dampening:
            raise ValueError(f"SGD: dampening={dampening} has no counterpart in the JAX package's optax.sgd")
        super().__init__(params, dict(lr=float(lr), momentum=float(momentum or 0.0),
                                      weight_decay=float(weight_decay), nesterov=bool(nesterov)))
        for group in self.param_groups:
            if group["momentum"]:
                for p in group["params"]:
                    self.state[p] = {"momentum_buffer": torch.zeros_like(p, memory_format=torch.preserve_format)}
        self.lr = _device_lr(self, lr)
        _track_state(self)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("SGD.step takes no closure")
        for group in self.param_groups:
            params = group["params"]
            if not params:
                continue
            grads = [p.grad for p in params]
            if group["weight_decay"]:
                grads = torch._foreach_add(grads, torch._foreach_mul(params, group["weight_decay"]))
            if group["momentum"]:
                trace = [self.state[p]["momentum_buffer"] for p in params]
                torch._foreach_mul_(trace, group["momentum"])
                torch._foreach_add_(trace, grads)
                update = (torch._foreach_add(grads, torch._foreach_mul(trace, group["momentum"]))
                          if group["nesterov"] else [t.clone() for t in trace])
            else:
                update = [g.clone() for g in grads]
            _apply_lr(self, params, update)

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        """Copy a ``state_dict``'s momentum buffers into this optimizer's, in place."""
        params = [p for group in self.param_groups for p in group["params"]]
        saved = state_dict["state"]
        for i, p in enumerate(params):
            entry = saved.get(i, saved.get(str(i)))
            if entry is not None and p in self.state:
                self.state[p]["momentum_buffer"].copy_(torch.as_tensor(entry["momentum_buffer"]).reshape(p.shape))


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """The learning rate of the next steps (``optax.inject_hyperparams``'s,
    the JAX ``set_lr``): into the optimizer's device scalar (no host
    synchronisation; a captured step reads it) and its parameter groups."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
    optimizer.lr.fill_(float(lr))


def square_norms(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Each tensor's sum of squares, one float32 vector: on the card from one
    multi-tensor reduction (``torch._foreach_norm``, squared); on the CPU
    from :func:`square_sums`, because PyTorch's CPU norm kernel adds in
    float32 in order (1e-4 off at 4M elements) where ``sum`` adds pairwise."""
    if not tensors:
        return torch.zeros(0, dtype=torch.float32)
    if tensors[0].device.type == "cuda":
        return torch.stack(torch._foreach_norm(list(tensors), 2, dtype=torch.float32)).square()
    return torch.stack(square_sums(tensors))


def square_sums(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each tensor's sum of squares (float32 scalars): what :func:`global_norm` adds up."""
    return [t.float().square().sum() for t in tensors]


def global_norm(tensors: Sequence[torch.Tensor], sums: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every element of every tensor
    (``optax.global_norm``), from the tensors' :func:`square_sums` when
    ``sums`` are given (the same operations: the same bits)."""
    return torch.sqrt(sum(square_sums(tensors) if sums is None else sums))


def clip_by_global_norm_(
    tensors: Sequence[torch.Tensor], max_norm: float, norm: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: each ``t`` becomes
    ``t / ‖g‖ · max_norm`` when ``‖g‖ ≥ max_norm``. Returns the norm before
    clipping, as a device tensor (no host synchronisation). ``norm``, when
    given, is ``‖g‖`` already taken by :func:`global_norm` (the learn
    probes', which keep its per-tensor sums), not taken again."""
    if norm is None:
        norm = global_norm(tensors)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(list(tensors), scale)
    return norm

"""Training-dynamics probes computed inside the train step (counterpart of
``sheeprl_tpu/obs/learn/probes.py``; the same keys and definitions).

:func:`learn_probes` runs on tensors the step already holds (gradients,
parameters, the applied updates, losses) and returns a flat
``{"learn/...": 0-dim float32 device tensor}`` dict: a handful of
reductions, no host synchronisation, so it is captured into the step's CUDA
graph with everything else. :class:`StepProbes` collects the same inputs
module by module inside a step (the raw gradients before the clip, the
parameters before the optimizer moves them, the optimizer's ‖lr·u‖²) and
:class:`LearnTap` keeps each call's probes in static buffers that the
program stacks over a burst (``train/burst.py``).

Probe definitions:

- ``learn/grad_norm``: global L2 norm over every module's raw gradients;
- ``learn/grad_norm/<module>``: per-module L2 norms of the raw gradients;
- ``learn/param_norm``: global L2 norm of the parameters entering the step;
- ``learn/update_ratio``: ‖updates‖ / (‖params‖ + eps), the update-to-weight
  ratio;
- ``learn/clip_frac``: the fraction of clip-configured modules whose raw
  gradient norm exceeded their global-norm clip this step;
- ``learn/nonfinite``: the count of gradient tensors (plus loss entries)
  holding any non-finite value.

Each module's tensors are reduced once, a float32 sum of squares a
tensor: a clipped module's gradients by the clip's own per-tensor sums
(``utils/optim.square_sums``), whose global norm is then handed to the clip
(:func:`probe_update`'s ``grad_norm``: the same operations, so the step
computes the same bits with the probes on or off, and the gradients are
not reduced twice); every other tensor set by ``utils/optim.square_norms``
(one multi-tensor reduction on the card). A tensor is non-finite where its
sum is (a NaN or an infinity in it, or a sum past float32's range, where
the global norm is infinite as well).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

__all__ = [
    "LEARN_PREFIX",
    "LearnTap",
    "Probed",
    "StepProbes",
    "learn_probes",
    "probe_losses",
    "probe_optimizer",
    "probe_record",
    "probe_update",
    "split_probes",
    "tapped",
]

#: the probes of the step call running on this thread (None outside a tapped call)
_ACTIVE = threading.local()

#: metric-dict key prefix of the probes
LEARN_PREFIX = "learn/"

#: update-ratio denominator guard (a zero-norm parameter set is init-only)
_EPS = 1e-12


def _leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a tensor, a module, or a (nested) mapping / sequence of them."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, Mapping):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return []


def _square_norms(tree: Any) -> Optional[torch.Tensor]:
    """Every tensor's sum of squares, one float32 vector
    (``utils/optim.square_norms``); None when ``tree`` holds no tensor."""
    from sheeprl_tpu_torch.utils.optim import square_norms

    leaves = [x.detach() for x in _leaves(tree)]
    return square_norms(leaves) if leaves else None


def _sq(sums: Optional[torch.Tensor]) -> torch.Tensor:
    """Sum of squares over every element of every tensor (float32 scalar)."""
    return sums.sum() if sums is not None else torch.zeros((), dtype=torch.float32)


def _nonfinite(sums: Optional[torch.Tensor]) -> torch.Tensor:
    """Count of tensors with any non-finite entry (float32 scalar)."""
    return (~torch.isfinite(sums)).sum().float() if sums is not None else torch.zeros((), dtype=torch.float32)


def _sq_norm(tree: Any) -> torch.Tensor:
    return _sq(_square_norms(tree))


def _nonfinite_leaves(tree: Any) -> torch.Tensor:
    return _nonfinite(_square_norms(tree))


def _assemble(
    grad_sq: Mapping[str, torch.Tensor],
    nonfinite: torch.Tensor,
    clip_norms: Mapping[str, Optional[float]],
    param_sq: Optional[Mapping[str, torch.Tensor]],
    update_sq: Optional[Mapping[str, torch.Tensor]],
) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    total = None
    clip_flags = []
    for name in sorted(grad_sq):
        sq = grad_sq[name]
        gnorm = torch.sqrt(sq)
        total = sq if total is None else total + sq
        out[f"{LEARN_PREFIX}grad_norm/{name}"] = gnorm
        clip = clip_norms.get(name)
        if clip is not None and clip > 0:
            clip_flags.append((gnorm > clip).float())
    zero = torch.zeros((), dtype=torch.float32, device=nonfinite.device)
    out[f"{LEARN_PREFIX}grad_norm"] = torch.sqrt(total) if total is not None else zero
    out[f"{LEARN_PREFIX}clip_frac"] = sum(clip_flags) / float(len(clip_flags)) if clip_flags else zero.clone()
    out[f"{LEARN_PREFIX}nonfinite"] = nonfinite
    if param_sq is not None:
        param_norm = torch.sqrt(sum(param_sq.values()))
        out[f"{LEARN_PREFIX}param_norm"] = param_norm
        if update_sq is not None:
            out[f"{LEARN_PREFIX}update_ratio"] = torch.sqrt(sum(update_sq.values())) / (param_norm + _EPS)
    return out


def learn_probes(
    grads: Mapping[str, Any],
    params: Optional[Mapping[str, Any]] = None,
    updates: Optional[Mapping[str, Any]] = None,
    losses: Any = None,
    *,
    clip_norms: Optional[Mapping[str, Optional[float]]] = None,
) -> Dict[str, torch.Tensor]:
    """The probe dict of one gradient step.

    ``grads``/``params``/``updates`` map a module name to its tensors (a
    tensor, a module, or a mapping or sequence of them): the raw gradients,
    the parameters the step started from and the updates it applied.
    ``losses`` are folded into the non-finite count; ``clip_norms`` maps a
    module to its global-norm clip (absent or None: not clipped)."""
    nonfinite = _nonfinite_leaves(losses) if losses is not None else torch.zeros((), dtype=torch.float32)
    grad_sq = {}
    for name in sorted(grads):
        sums = _square_norms(grads[name])
        grad_sq[name] = _sq(sums)
        nonfinite = nonfinite + _nonfinite(sums)
    param_sq = {k: _sq_norm(v) for k, v in dict(params).items()} if params is not None else None
    update_sq = {k: _sq_norm(v) for k, v in dict(updates).items()} if updates is not None else None
    return _assemble(grad_sq, nonfinite, dict(clip_norms or {}), param_sq, update_sq)


class StepProbes:
    """One gradient step's probes, collected module by module as the step
    runs: :meth:`before_update` on the raw gradients (before the clip) and
    the parameters (before the optimizer step), :meth:`after_update` on the
    optimizer that applied the update (its ``update_sq``, ‖lr·u‖², which the
    port's optimizers write while ``track_updates`` is on), :meth:`result`
    at the end. A module seen twice in one step (an ensemble of critics
    stepped one by one) sums its squares."""

    def __init__(self):
        self.losses: Any = None
        self.grad_sq: Dict[str, torch.Tensor] = {}
        self.param_sq: Dict[str, torch.Tensor] = {}
        self.update_sq: Dict[str, torch.Tensor] = {}
        self.clip_norms: Dict[str, Optional[float]] = {}
        self.nonfinite: Optional[torch.Tensor] = None

    @staticmethod
    def _add(acc: Dict[str, torch.Tensor], name: str, value: torch.Tensor) -> None:
        acc[name] = value if name not in acc else acc[name] + value

    def before_update(
        self, name: str, grads: Any, params: Any, clip: Optional[float] = None
    ) -> Optional[torch.Tensor]:
        """Probe the raw gradients and the parameters. With a clip, returns
        the gradients' global norm as ``utils/optim.global_norm`` takes it,
        for the clip to reuse; else None."""
        clipped = clip is not None and clip > 0
        grad_norm = None
        if clipped:
            from sheeprl_tpu_torch.utils.optim import square_sums

            sums = square_sums(_leaves(grads))
            grad_sq = sum(sums)
            grad_norm = torch.sqrt(grad_sq)  # utils/optim.global_norm's operations on the same sums
            count = (~torch.isfinite(torch.stack(sums))).sum().float()
            self.clip_norms[name] = float(clip)
        else:
            sums = _square_norms(grads)
            grad_sq, count = _sq(sums), _nonfinite(sums)
        self._add(self.grad_sq, name, grad_sq)
        self._add(self.param_sq, name, _sq_norm(params))
        self.nonfinite = count if self.nonfinite is None else self.nonfinite + count
        return grad_norm

    def after_update(self, name: str, optimizer: torch.optim.Optimizer) -> None:
        """Read the update ``optimizer`` just applied (``track_updates`` on)."""
        self._add(self.update_sq, name, optimizer.update_sq.clone())

    def result(self, losses: Any = None) -> Dict[str, torch.Tensor]:
        losses = self.losses if losses is None else losses
        nonfinite = self.nonfinite if self.nonfinite is not None else torch.zeros((), dtype=torch.float32)
        if losses is not None:
            nonfinite = nonfinite + _nonfinite_leaves(losses)
        return _assemble(
            self.grad_sq, nonfinite, self.clip_norms, self.param_sq if self.param_sq else None,
            self.update_sq if self.update_sq and self.param_sq else None,
        )


class LearnTap:
    """The probes of every call of a train step, kept for the sentinel.

    Inside the step, :meth:`begin` starts a call's :class:`StepProbes` and
    :meth:`record` copies a finished probe dict into a static buffer (one a
    record site: a step may record several times, DroQ's critic steps then
    its actor step), so that a CUDA graph's replay rewrites the same
    buffers. Around the step, :meth:`collect` keeps a copy of the buffers
    after each call (a device copy, no synchronisation) and :meth:`flush`
    hands the calls' stacked probes to ``obs.learn.observe_probes``: one
    device→host pull a burst, at the sentinel's cadence."""

    def __init__(self):
        self._sites: List[Tuple[List[str], torch.Tensor]] = []
        self._site = 0
        self._rows: List[List[torch.Tensor]] = []

    def begin(self) -> StepProbes:
        """Start a call: its probes are this thread's :func:`probe_update` target."""
        self._site = 0
        probes = StepProbes()
        _ACTIVE.probes, _ACTIVE.tap = probes, self
        return probes

    def end(self) -> None:
        """Finish a call: record the probes collected since :meth:`begin`
        (or since the last :func:`probe_record`)."""
        probes = getattr(_ACTIVE, "probes", None)
        _ACTIVE.probes = _ACTIVE.tap = None
        if probes is not None and probes.grad_sq:
            self.record(probes.result())

    def record(self, probes: Mapping[str, torch.Tensor]) -> None:
        names = sorted(probes)
        values = torch.stack([probes[k].detach().float().reshape(()) for k in names])
        if self._site == len(self._sites):
            self._sites.append((names, torch.zeros_like(values)))
        keys, buffer = self._sites[self._site]
        if keys != names:
            raise ValueError(f"learn probes changed their keys between calls: {keys} != {names}")
        buffer.copy_(values)
        self._site += 1

    def last(self) -> Dict[str, torch.Tensor]:
        """The last call's probes, read from the static buffers (a record
        site's key seen again later overwrites it)."""
        return {k: buffer[j] for keys, buffer in self._sites for j, k in enumerate(keys)}

    def collect(self) -> None:
        """Keep this call's probes (after the step ran or replayed)."""
        self._rows.append([buffer.clone() for _keys, buffer in self._sites])

    def stacked(self) -> Optional[Dict[str, torch.Tensor]]:
        """The collected calls' probes by key, each a 1-D device tensor (the
        record sites in order), and forget them; None when nothing was kept."""
        rows, self._rows = self._rows, []
        if not rows or not self._sites:
            return None
        out: Dict[str, List[torch.Tensor]] = {}
        for s, (keys, _buffer) in enumerate(self._sites):
            values = torch.stack([row[s] for row in rows])  # [calls, keys]
            for j, key in enumerate(keys):
                out.setdefault(key, []).append(values[:, j])
        return {k: torch.cat(v) if len(v) > 1 else v[0] for k, v in out.items()}

    def flush(self, step: Optional[int] = None) -> None:
        from sheeprl_tpu_torch.obs.learn import observe_probes

        observe_probes(self.stacked(), step=step)


def _active() -> Optional[StepProbes]:
    return getattr(_ACTIVE, "probes", None)


class Probed:
    """What :func:`probe_update` returns: called just after the optimizer
    step, it reads the applied update; ``grad_norm`` is the raw gradients'
    global norm the probes took as the clip takes it, for
    ``clip_by_global_norm_(norm=)`` (None with the probes off or no clip:
    the clip then reduces the gradients itself)."""

    __slots__ = ("_after", "grad_norm")

    def __init__(self, after: Optional[Callable[[], None]] = None, grad_norm: Optional[torch.Tensor] = None):
        self._after = after
        self.grad_norm = grad_norm

    def __call__(self) -> None:
        if self._after is not None:
            self._after()


#: the probes off: a no-op, no norm
_OFF = Probed()


def probe_update(
    name: str, grads: Sequence[torch.Tensor], params: Any, optimizer: torch.optim.Optimizer,
    clip: Optional[float] = None,
) -> Probed:
    """Inside a tapped step call, just before ``optimizer`` steps module
    ``name``: probe the raw gradients and the parameters now and return the
    :class:`Probed` to call just after the step (it reads the applied
    update). Outside a tapped call it is a no-op with no norm, so a step
    built without probes runs exactly the operations it ran before."""
    probes = _active()
    if probes is None:
        return _OFF
    grad_norm = probes.before_update(name, grads, params, clip)
    optimizer.track_updates = True
    return Probed(lambda: probes.after_update(name, optimizer), grad_norm)


def probe_optimizer(name: str, optimizer: torch.optim.Optimizer, clip: Optional[float] = None) -> Probed:
    """:func:`probe_update` of the parameters ``optimizer`` steps (and their
    gradients)."""
    if _active() is None:
        return _OFF
    params = [p for group in optimizer.param_groups for p in group["params"]]
    return probe_update(name, [p.grad for p in params], params, optimizer, clip)


def probe_record(*losses: torch.Tensor) -> None:
    """Inside a tapped step call: record the probes collected so far as one
    sample (with ``losses`` in the non-finite count) and start the next: a
    step that makes several gradient steps (DroQ's critic steps) records
    one sample each."""
    probes, tap = _active(), getattr(_ACTIVE, "tap", None)
    if probes is None or tap is None:
        return
    tap.record(probes.result(losses))
    _ACTIVE.probes = StepProbes()


def probe_losses(*losses: torch.Tensor) -> None:
    """Inside a tapped step call: the losses folded into the non-finite count."""
    probes = _active()
    if probes is not None:
        probes.losses = losses


def tapped(body: Callable[..., Any], tap: Optional["LearnTap"]) -> Callable[..., Any]:
    """``body`` whose every call records its probes into ``tap``; ``body``
    itself when ``tap`` is None (the probes off)."""
    if tap is None:
        return body

    def run(*args, **kwargs):
        tap.begin()
        try:
            return body(*args, **kwargs)
        finally:
            tap.end()

    return run


def split_probes(metrics: Any) -> Tuple[Any, Optional[Dict[str, Any]]]:
    """Partition a metric dict into ``(rest, learn_subtree_or_None)``;
    anything but a dict passes through untouched."""
    if not isinstance(metrics, dict):
        return metrics, None
    learn = {k: v for k, v in metrics.items() if k.startswith(LEARN_PREFIX)}
    if not learn:
        return metrics, None
    rest = {k: v for k, v in metrics.items() if not k.startswith(LEARN_PREFIX)}
    return rest, learn

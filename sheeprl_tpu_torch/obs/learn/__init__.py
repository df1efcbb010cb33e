"""Learning-health observability: probes computed inside the train step and
the divergence sentinel (counterpart of ``sheeprl_tpu/obs/learn``).

The machine-health planes (spans, counters, roofline, staleness) say nothing
about whether the *learning* is healthy: a diverging run looks like a
converging one in ``telemetry.json`` until the NaN guard fires. Two pieces:

- :mod:`~sheeprl_tpu_torch.obs.learn.probes`: ``learn_probes(...)``, global
  and per-module gradient norms, the update-to-weight ratio, the parameter
  norm, the clip fraction and the non-finite count, computed inside the
  train step (captured into its CUDA graph) as 0-dim device tensors under
  the ``learn/`` prefix; a program keeps each call's probes and hands a
  burst's stack to :func:`observe_probes`, one device→host pull a burst;
- :mod:`~sheeprl_tpu_torch.obs.learn.sentinel`: streaming-histogram
  baselines per probe with graded events (``warn`` on grad-norm z-score
  excursions or update-ratio collapse, ``critical`` on sustained explosion
  before any NaN lands, or on non-finite gradients), each firing the flight
  recorder's ``learn_divergence`` trigger.

The sentinel is installed by the telemetry (``metric.telemetry.learn``);
without it :func:`probes_enabled` is False, the train steps are built
without a single probe operation, and a run is bitwise the run with the
telemetry off.
"""

from __future__ import annotations

from typing import Any, Optional

from sheeprl_tpu_torch.obs.learn.probes import (
    LEARN_PREFIX,
    LearnTap,
    StepProbes,
    learn_probes,
    probe_losses,
    probe_optimizer,
    probe_record,
    probe_update,
    split_probes,
    tapped,
)
from sheeprl_tpu_torch.obs.learn.sentinel import LearnSentinel

__all__ = [
    "LEARN_PREFIX",
    "LearnSentinel",
    "LearnTap",
    "StepProbes",
    "install",
    "installed",
    "learn_probes",
    "learn_tap",
    "observe_probes",
    "probe_losses",
    "probe_optimizer",
    "probe_record",
    "probe_update",
    "probes_enabled",
    "split_probes",
    "tapped",
]

_SENTINEL: Optional[LearnSentinel] = None


def install(sentinel: Optional[LearnSentinel]) -> None:
    """Activate (or with ``None`` deactivate) the run's learn sentinel."""
    global _SENTINEL
    _SENTINEL = sentinel


def installed() -> Optional[LearnSentinel]:
    return _SENTINEL


def probes_enabled(cfg: Any = None) -> bool:
    """Should the train step being built compute learn probes? True exactly
    when a sentinel is installed (telemetry on and
    ``metric.telemetry.learn.enabled``): the build-time gate, so a step
    built without it carries no probe operation. ``cfg`` is accepted for
    call-site symmetry; the installed sentinel decides."""
    return _SENTINEL is not None


def learn_tap() -> Optional[LearnTap]:
    """A :class:`LearnTap` for a train step being built, or None when the
    probes are off."""
    return LearnTap() if probes_enabled() else None


def observe_probes(probes: Any, step: Optional[int] = None) -> None:
    """Feed one burst's stacked probes (``{key: device tensor}``) to the
    sentinel. They are pulled to the host in one copy, and only when the
    sentinel's ``every_n_bursts`` cadence is due (``learn_probe_fetches``
    counts every pull). A no-op when ``probes`` is None or no sentinel is
    installed."""
    s = _SENTINEL
    if s is None or probes is None:
        return
    if not s.due_burst():
        return
    import torch

    from sheeprl_tpu_torch.obs.counters import add_learn_fetch

    keys = sorted(probes)
    flat = [torch.as_tensor(probes[k]).detach().reshape(-1).float() for k in keys]
    pulled = torch.cat([t.to(flat[0].device) for t in flat]).cpu().numpy() if flat else None
    add_learn_fetch()
    if pulled is None:
        return
    vals, i = {}, 0
    for k, t in zip(keys, flat):
        vals[k] = pulled[i:i + t.numel()]
        i += t.numel()
    s.observe(vals, step=step)

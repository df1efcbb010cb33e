"""Train bursts (counterpart of ``sheeprl_tpu/train/burst.py``).

A *train burst* is one replay-staged block of ``n_samples`` gradient steps.
:func:`build_train_burst` (the JAX package's name for the
:class:`TrainProgram` constructor) wraps the body of one gradient step. Calling the program is the eager step. Its
``.burst`` runs the block with the whole gradient step replayed from one
CUDA graph per sample (:class:`~sheeprl_tpu_torch.train.graphs.CapturedStep`):
the program holds static inputs for the batch, the step's noise and the
target update ``tau``; before each replay the host copies the sample's
batch in, draws the noise into its buffers and sets ``tau``; the metrics are
the graph's static outputs. The JAX package runs the same block as one
jitted ``fori_loop``; here the host still issues one replay a sample, and
no host synchronisation happens inside a burst.

The eager loop stays callable by name, ``run_train_burst(...,
fused=False)``: the parity side, as ``SHEEPRL_TRAIN_NO_FUSE=1`` is in JAX.
No environment variable or config key selects it. On the CPU ``.burst``
runs the same body eagerly over the same static inputs.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from sheeprl_tpu_torch.train.graphs import CapturedStep

__all__ = ["TrainProgram", "build_train_burst", "metric_fetch_gate", "run_train_burst", "tau_schedule"]

Batch = Dict[str, torch.Tensor]
Noise = Dict[str, Any]


def _noise_tensors(noise: Noise) -> List[torch.Tensor]:
    return [t for v in noise.values() for t in (v if isinstance(v, (list, tuple)) else [v])]


class _Static:
    """The captured step over static buffers, for the one agent state and
    the one batch shape its program bursts on."""

    def __init__(self, program: "TrainProgram", state: Dict[str, Any], example: Batch):
        self.state = state
        self.data = {k: torch.zeros_like(v) for k, v in example.items()}
        T, B = example["rewards"].shape[:2]
        device = example["rewards"].device
        self.noise = program._draw_noise(T, B, None, device)
        self.tau = torch.zeros((), dtype=torch.float32, device=device)
        program.prepare(state)
        self.step = CapturedStep(lambda: program._body(state, self.data, self.noise, self.tau), device)

    def set_noise(self, noise: Noise) -> None:
        for dst, src in zip(_noise_tensors(self.noise), _noise_tensors(noise), strict=True):
            dst.copy_(src)


class TrainProgram:
    """``program(state, data, noise=None, tau=0.0)`` is one eager gradient
    step; ``program.burst(state, data_stack, taus, noise=None)`` runs
    ``len(taus)`` steps over ``data_stack[k][i]``, each replayed from the
    captured step on the card. ``noise`` is None (drawn from
    ``state["generator"]``) or, for the burst, one noise dict a sample.
    Both return the (last) step's metrics as 0-dim device tensors.

    ``body(state, data, noise, tau)`` runs one gradient step on ``state``
    in place and returns its metrics as 0-dim device tensors; it reads its
    inputs only through its arguments and the state's tensors, and makes no
    host branch on device values and no host synchronisation, so that one
    capture of it is every step. ``draw_noise(T, B, generator, device)``
    gives one step's noise; ``prepare(state)`` allocates what the body
    updates in place (the gradients) before the first call.

    A program bursts on one agent state at one batch shape: ``.static``, the
    captured step and its buffers, is made by the first burst (None before)
    and a later burst on another state or shape raises."""

    def __init__(
        self,
        body: Callable[[Dict[str, Any], Batch, Noise, torch.Tensor], Dict[str, torch.Tensor]],
        draw_noise: Callable[[int, int, Optional[torch.Generator], Any], Noise],
        prepare: Callable[[Dict[str, Any]], None],
    ):
        self._body = body
        self._draw_noise = draw_noise
        self.prepare = prepare
        self.static: Optional[_Static] = None

    def __call__(self, state: Dict[str, Any], data: Batch, noise: Optional[Noise] = None, tau: float = 0.0):
        T, B = data["rewards"].shape[:2]
        device = data["rewards"].device
        if noise is None:
            noise = self._draw_noise(T, B, state.get("generator"), device)
        self.prepare(state)
        return self._body(state, data, noise, torch.tensor(float(tau), dtype=torch.float32, device=device))

    def _static_for(self, state: Dict[str, Any], data_stack: Batch) -> _Static:
        if self.static is None:
            self.static = _Static(self, state, {k: v[0] for k, v in data_stack.items()})
        static = self.static
        same = static.state is state and static.data.keys() == data_stack.keys() and all(
            v.shape == data_stack[k].shape[1:] and v.dtype == data_stack[k].dtype and v.device == data_stack[k].device
            for k, v in static.data.items()
        )
        if not same:
            raise ValueError("a TrainProgram bursts on one agent state at one batch shape, dtype and device")
        return static

    def burst(
        self,
        state: Dict[str, Any],
        data_stack: Batch,
        taus: Sequence[float],
        noise: Optional[Sequence[Noise]] = None,
    ) -> Dict[str, torch.Tensor]:
        static = self._static_for(state, data_stack)
        T, B = static.data["rewards"].shape[:2]
        device = static.tau.device
        taus_dev = torch.as_tensor(np.asarray(taus, dtype=np.float32)).to(device, non_blocking=True)
        metrics = None
        for i in range(len(taus)):
            for k, v in static.data.items():
                v.copy_(data_stack[k][i], non_blocking=True)
            static.set_noise(noise[i] if noise is not None else self._draw_noise(T, B, state.get("generator"), device))
            static.tau.copy_(taus_dev[i])
            metrics = static.step()
        return metrics


build_train_burst = TrainProgram


def tau_schedule(n: int, start: int, every: int, *, tau: float = 1.0, first_hard: bool = True) -> np.ndarray:
    """The target update for gradient steps ``start..start+n-1``: ``tau`` on
    every ``every``-th step, 0 off it. Hard-copy families (DreamerV2) pass
    ``tau=1.0, first_hard=False``; EMA families their soft ``tau`` with
    ``first_hard=True``, so the run's very first step copies whatever the
    cadence."""
    g = int(start) + np.arange(int(n), dtype=np.int64)
    out = np.where(g % max(int(every), 1) == 0, np.float32(tau), np.float32(0.0))
    if first_hard:
        out = np.where(g == 0, np.float32(1.0), out)
    return out.astype(np.float32)


def metric_fetch_gate(
    cfg,
    aggregator,
    *,
    policy_step: int,
    last_log: int,
    train_step: int,
    update: int,
    num_updates: int,
    policy_steps_per_update: int,
    world_size: int,
) -> bool:
    """Should this burst's metrics be pulled to the host? Not without an
    aggregator; yes when a log boundary falls before the next burst (bursts
    recur every ``max(train_every // policy_steps_per_update, 1)`` updates)
    or the run's last burst is due; else every
    ``metric.fetch_train_metrics_every``-th burst (0: only before a log)."""
    if aggregator is None or aggregator.disabled:
        return False
    burst_updates = max(int(cfg.algo.train_every) // int(policy_steps_per_update), 1)
    burst_period = burst_updates * int(policy_steps_per_update)
    will_log = cfg.metric.log_level > 0 and (
        policy_step - last_log + burst_period >= cfg.metric.log_every
        # the run's last burst feeds the final update==num_updates log even
        # when that update itself is not a burst
        or update + burst_updates > num_updates
    )
    fetch_every = int(cfg.metric.get("fetch_train_metrics_every", 1))
    return will_log or (fetch_every > 0 and (train_step // world_size) % fetch_every == 0)


def run_train_burst(
    program: TrainProgram,
    state: Dict[str, Any],
    data_stack: Batch,
    taus: Sequence[float],
    *,
    fetch_metrics: bool = True,
    fused: bool = True,
    noise: Optional[Sequence[Noise]] = None,
    pacing_metric: str = "Loss/world_model_loss",
) -> Optional[Dict[str, float]]:
    """Run one burst: ``program.burst`` (``fused``) or the eager step once a
    sample (the parity side). Returns the last step's metrics as floats,
    pulled in one copy, when ``fetch_metrics``; else waits for the burst
    through one scalar (the stream's work up to it) and returns None."""
    if fused:
        metrics = program.burst(state, data_stack, taus, noise)
    else:
        for i in range(len(taus)):
            metrics = program(
                state, {k: v[i] for k, v in data_stack.items()}, None if noise is None else noise[i], float(taus[i])
            )
    if fetch_metrics:
        names = list(metrics)
        values = torch.stack([metrics[k].detach().float().reshape(()) for k in names]).tolist()
        return dict(zip(names, values))
    metrics[pacing_metric].item()
    return None

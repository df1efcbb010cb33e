"""Device/transfer/graph counters (counterpart of ``sheeprl_tpu/obs/counters.py``:
the same fields and producer helpers, so ``Counters().as_dict()`` has the JAX
package's keys, plus ``graph_replays``).

Three measurement families, all host-side and sync-free:

- **host→device transfer accounting**: the replay staging path
  (:mod:`sheeprl_tpu_torch.data.staging`, the pinned-host→device copy of a
  burst) reports the host bytes it ships via :func:`add_h2d_bytes`.
- **CUDA-graph accounting**, where the JAX package listens to
  ``jax.monitoring`` for XLA compiles. The keys keep the JAX names:

  ======================  ==================================================
  key                     on CUDA
  ======================  ==================================================
  ``recompiles``          CUDA-graph captures (``train/graphs.CapturedStep``)
  ``compile_secs``        host seconds of those steps' eager warm-up calls
                          and their captures
  ``compile_cache_hits``  kernel libraries loaded from the build directory
                          without a build (``kernels/build.py``)
  ``graph_replays``       CUDA-graph replays (no JAX counterpart)
  ======================  ==================================================

  :func:`set_compile_hook` installs a callback fired on every capture (its
  warm-up and capture seconds); the run telemetry fires the flight recorder
  for a capture made after ``flight.recompile_warmup_s``.
- **device memory**: :func:`device_memory_stats` reads
  ``torch.cuda.memory_stats`` (the caching allocator's own books, no device
  synchronisation) and the card's total memory; :class:`DevicePoller`
  samples it on a background thread and tracks the run's peak. The H100's
  memory is HBM3, so the ``hbm`` names stay true. On the CPU it reports
  nothing, as the JAX package's does on a CPU backend.

All counters are no-ops until :func:`install` is called (by
``setup_telemetry``): the module-global pointer is ``None`` and every hot
path is a single attribute check.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

__all__ = [
    "Counters",
    "add_act_dispatches",
    "add_ckpt_blocked_ms",
    "add_ckpt_write",
    "add_env_async_steps",
    "add_env_degraded",
    "add_compile_cache_hit",
    "add_env_worker_restart",
    "add_graph_capture",
    "add_graph_replays",
    "add_h2d_bytes",
    "add_kernel_tier_degraded",
    "add_learn_fetch",
    "add_plane_player_restart",
    "add_plane_slabs",
    "add_prefetch",
    "add_replay_adoption",
    "add_replay_priority_updates",
    "add_ring_gather",
    "add_rollout_burst",
    "add_serve_batch",
    "add_serve_failed",
    "add_serve_requests",
    "add_serve_swap",
    "add_serve_traced",
    "add_slo_alert",
    "add_train_burst",
    "set_replay_shard_fill",
    "note_plane_policy_version",
    "device_memory_stats",
    "DevicePoller",
    "install",
    "installed",
    "set_compile_hook",
    "staged_device_put",
    "tree_nbytes",
]

_COUNTERS: Optional["Counters"] = None
#: telemetry-installed callback fired on every CUDA-graph capture (its
#: warm-up and capture seconds); the flight recorder uses it to catch a
#: capture made after warm-up
_COMPILE_HOOK: Optional[Any] = None


def set_compile_hook(hook) -> None:
    """Install (or with ``None`` remove) the graph-capture callback."""
    global _COMPILE_HOOK
    _COMPILE_HOOK = hook


class Counters:
    """Thread-safe run counters (players/trainers/pollers all write here)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.h2d_bytes = 0
        self.h2d_transfers = 0
        self.recompiles = 0
        self.compile_secs = 0.0
        self.compile_cache_hits = 0
        self.graph_replays = 0
        self.nonfinite_metrics = 0
        self.stalls = 0
        self.ckpt_blocked_ms = 0.0
        self.ckpt_write_ms = 0.0
        self.ckpt_bytes = 0
        self.ckpt_saves = 0
        self.ckpt_failures = 0
        # replay staging (data/staging.py): ring gathers never re-cross the
        # host→HBM link; prefetch hits are bursts whose sampling + H2D ran
        # overlapped with the previous train burst, wait_ms the residue the
        # train thread still blocked on a not-yet-ready prefetched batch
        self.ring_gathers = 0
        self.prefetch_hits = 0
        self.prefetch_misses = 0
        self.prefetch_wait_ms = 0.0
        # async env execution plane (envs/vector): steps served by the
        # shared-memory worker pool, worker crash/hang restarts, and whether
        # the pool gave up and degraded to in-process sync stepping
        self.env_steps_async = 0
        self.env_worker_restarts = 0
        self.env_degraded_to_sync = 0
        # acting: `rollout_bursts` counts collection bursts (a loop's or a
        # player's acting step, or one burst of the rollout engine),
        # `act_dispatches` the policy calls paid for them (a graph replay or
        # an eager call each), and `env_steps_jax` the env steps taken on
        # the device (env.backend=jax's device envs; the key keeps the JAX
        # name)
        self.rollout_bursts = 0
        self.act_dispatches = 0
        self.env_steps_jax = 0
        # train bursts (sheeprl_tpu_torch/train, the SAC family's StepProgram):
        # `train_bursts` counts a loop's blocks of gradient steps,
        # `train_dispatches` the step calls paid for them (one graph replay
        # or eager call a gradient step) and `train_burst_steps` the
        # gradient steps
        self.train_bursts = 0
        self.train_dispatches = 0
        self.train_burst_steps = 0
        # actor–learner plane (sheeprl_tpu_torch/plane): trajectory slabs received
        # by the learner over the shared-memory queues, the newest published
        # policy version (a gauge — max, not a sum), and player processes
        # respawned after a crash
        self.plane_traj_slabs = 0
        self.plane_policy_version = 0
        self.plane_player_restarts = 0
        # sharded replay plane (sheeprl_tpu_torch/replay): priority rows rewritten
        # by the TD-priority writeback channel, slabs adopted straight into
        # the device ring (0 here: replay.adopt_slabs is ROADMAP 6j), and a
        # per-shard fill gauge ({shard -> fraction}, set after every ingest)
        self.replay_priority_updates = 0
        self.replay_adoptions = 0
        self.replay_shard_fill: Dict[str, float] = {}
        # collectives (the JAX package's obs/dist/comms.py; 0 here until
        # multi-card training, ROADMAP 7): ops, payload bytes, wall ms, and a
        # per-kind breakdown
        self.comms_ops = 0
        self.comms_bytes = 0
        self.comms_ms = 0.0
        self.comms_by_kind: Dict[str, Dict[str, Any]] = {}
        # parameter sharding (the JAX package's parallel/; 0 and 1 here: one
        # device): per-device footprint of the parameters and optimizer
        # state, and the model-axis size
        self.params_bytes_per_device = 0
        self.opt_state_bytes_per_device = 0
        self.model_axis_size = 1
        # kernel tiers auto-degraded at build time (0 here: the port's kernels
        # have one tier, and a launch that fails raises)
        self.kernel_tier_degraded = 0
        # evaluation subsystem (sheeprl_tpu_torch/evals): service rounds and
        # episodes run in this process, plus in-run eval policy publications
        # (the async channel feeding the separate eval process — the eval
        # episodes themselves run over there, never in the trainer)
        self.eval_rounds = 0
        self.eval_episodes = 0
        self.inrun_eval_publishes = 0
        # policy-serving gateway (sheeprl_tpu_torch/serve): act() requests accepted,
        # coalesced batch dispatches paid for them (requests/batches is the
        # coalescing factor), the rows those batches carried (rows/batches is
        # mean batch occupancy), batches the dispatcher could not launch by
        # their latency deadline (the device was still busy — the flight-
        # recorder trigger), in-place model hot-swaps, and requests that
        # failed (errored or abandoned at drain)
        self.serve_requests = 0
        self.serve_batches = 0
        self.serve_batch_rows = 0
        self.serve_deadline_misses = 0
        self.serve_swaps = 0
        self.serve_failed_requests = 0
        # request-path observability (obs/reqtrace + obs/slo): requests whose
        # six-stage span chain landed in the trace plane, and SLO burn-rate
        # alert firings (fast + slow pairs; clears are not counted)
        self.serve_traced_requests = 0
        self.slo_alerts_fired = 0
        # learning-health plane (ROADMAP 6h-c; 0 until it is ported): graded sentinel
        # events plus the extra device→host probe pulls actually paid (the
        # "uninstrumented runs pay nothing" invariant is asserted on
        # learn_probe_fetches staying 0 when learn probes are off)
        self.learn_warnings = 0
        self.learn_criticals = 0
        self.learn_probe_fetches = 0

    def add_learn_event(self, warnings: int = 0, criticals: int = 0) -> None:
        with self._lock:
            self.learn_warnings += int(warnings)
            self.learn_criticals += int(criticals)

    def add(self, field: str, amount) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + amount)

    def add_comms(
        self, kind: str, payload_bytes: int, ms: float, gbps: Optional[float] = None
    ) -> None:
        """Record one host-level collective (obs/dist/comms.py)."""
        with self._lock:
            self.comms_ops += 1
            self.comms_bytes += int(payload_bytes)
            self.comms_ms += float(ms)
            k = self.comms_by_kind.setdefault(
                kind, {"ops": 0, "bytes": 0, "ms": 0.0, "last_gbps": None, "best_gbps": None}
            )
            k["ops"] += 1
            k["bytes"] += int(payload_bytes)
            k["ms"] += float(ms)
            if gbps is not None:
                k["last_gbps"] = round(gbps, 3)
                if k["best_gbps"] is None or gbps > k["best_gbps"]:
                    k["best_gbps"] = round(gbps, 3)

    def as_dict(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "bytes_staged_h2d": self.h2d_bytes,
                "h2d_transfers": self.h2d_transfers,
                "recompiles": self.recompiles,
                "compile_secs": round(self.compile_secs, 3),
                "compile_cache_hits": self.compile_cache_hits,
                "graph_replays": self.graph_replays,
                "nonfinite_metrics": self.nonfinite_metrics,
                "stalls": self.stalls,
                "ckpt_blocked_ms": round(self.ckpt_blocked_ms, 1),
                "ckpt_write_ms": round(self.ckpt_write_ms, 1),
                "ckpt_bytes": self.ckpt_bytes,
                "ckpt_saves": self.ckpt_saves,
                "ckpt_failures": self.ckpt_failures,
                "ring_gathers": self.ring_gathers,
                "prefetch_hits": self.prefetch_hits,
                "prefetch_misses": self.prefetch_misses,
                "prefetch_wait_ms": round(self.prefetch_wait_ms, 1),
                "env_steps_async": self.env_steps_async,
                "env_worker_restarts": self.env_worker_restarts,
                "env_degraded_to_sync": self.env_degraded_to_sync,
                "rollout_bursts": self.rollout_bursts,
                "act_dispatches": self.act_dispatches,
                "env_steps_jax": self.env_steps_jax,
                "train_bursts": self.train_bursts,
                "train_dispatches": self.train_dispatches,
                "train_burst_steps": self.train_burst_steps,
                "plane_traj_slabs": self.plane_traj_slabs,
                "plane_policy_version": self.plane_policy_version,
                "plane_player_restarts": self.plane_player_restarts,
                "replay_priority_updates": self.replay_priority_updates,
                "replay_adoptions": self.replay_adoptions,
                "replay_shard_fill": dict(self.replay_shard_fill),
                "params_bytes_per_device": self.params_bytes_per_device,
                "opt_state_bytes_per_device": self.opt_state_bytes_per_device,
                "model_axis_size": self.model_axis_size,
                "kernel_tier_degraded": self.kernel_tier_degraded,
                "eval_rounds": self.eval_rounds,
                "eval_episodes": self.eval_episodes,
                "inrun_eval_publishes": self.inrun_eval_publishes,
                "serve_requests": self.serve_requests,
                "serve_batches": self.serve_batches,
                "serve_batch_rows": self.serve_batch_rows,
                "serve_deadline_misses": self.serve_deadline_misses,
                "serve_swaps": self.serve_swaps,
                "serve_failed_requests": self.serve_failed_requests,
                "serve_traced_requests": self.serve_traced_requests,
                "slo_alerts_fired": self.slo_alerts_fired,
                "learn_warnings": self.learn_warnings,
                "learn_criticals": self.learn_criticals,
                "learn_probe_fetches": self.learn_probe_fetches,
                "comms_ops": self.comms_ops,
                "comms_bytes": self.comms_bytes,
                "comms_ms": round(self.comms_ms, 3),
                "comms": {
                    kind: {**v, "ms": round(v["ms"], 3)}
                    for kind, v in sorted(self.comms_by_kind.items())
                },
            }


def install(counters: Optional["Counters"]) -> None:
    """Activate (or with ``None`` deactivate) the run counters."""
    global _COUNTERS
    _COUNTERS = counters


def installed() -> Optional["Counters"]:
    return _COUNTERS


# -- transfer accounting ----------------------------------------------------


def tree_nbytes(tree: Any) -> int:
    """Total bytes of the *host* leaves (numpy arrays, CPU tensors) of a
    nested dict/list/tuple. Device tensors are skipped: they are not about
    to cross the host→device link again."""
    import numpy as np

    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    if isinstance(tree, np.ndarray):
        return int(tree.nbytes)
    if isinstance(tree, np.generic):
        return int(np.asarray(tree).nbytes)
    if isinstance(tree, bytes):
        return len(tree)
    if getattr(tree, "is_cuda", True) is False and hasattr(tree, "element_size"):
        return int(tree.numel() * tree.element_size())
    return 0


def add_h2d_bytes(nbytes: int, transfers: int = 1) -> None:
    """Record ``nbytes`` staged host→device (no-op when telemetry is off)."""
    c = _COUNTERS
    if c is not None and nbytes:
        with c._lock:
            c.h2d_bytes += int(nbytes)
            c.h2d_transfers += transfers


def count_h2d(tree: Any) -> None:
    """Record the host bytes of ``tree`` as one staged transfer.

    The size walk itself is skipped when telemetry is off, so hot loops can
    call this unconditionally.
    """
    if _COUNTERS is not None:
        add_h2d_bytes(tree_nbytes(tree))


def staged_device_put(data: Any, device: Any, non_blocking: bool = False):
    """``tensor.to(device)`` of a tree of host tensors, wrapped in the
    host→device staging span and its byte count. The span measures the
    enqueue of the copy (asynchronous from pinned memory), the byte count
    is exact either way."""
    from sheeprl_tpu_torch.obs.spans import span

    nbytes = tree_nbytes(data) if _COUNTERS is not None else 0

    def move(node):
        if isinstance(node, dict):
            return {k: move(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(move(v) for v in node)
        return node.to(device, non_blocking=non_blocking)

    with span("Time/stage_h2d_time", phase="stage_h2d"):
        out = move(data)
    add_h2d_bytes(nbytes)
    return out


# -- replay staging accounting ----------------------------------------------


def add_ring_gather(n: int = 1) -> None:
    """Record ``n`` device-ring batch gathers (no host→HBM batch upload)."""
    c = _COUNTERS
    if c is not None:
        with c._lock:
            c.ring_gathers += n


def add_prefetch(hit: bool, wait_ms: float = 0.0) -> None:
    """Record one prefetch-pipeline burst: a *hit* means the batch was
    sampled + staged while the previous train burst ran (``wait_ms`` is the
    residue the caller still blocked for); a *miss* means it was produced
    synchronously (cold start or a changed burst spec)."""
    c = _COUNTERS
    if c is not None:
        with c._lock:
            if hit:
                c.prefetch_hits += 1
            else:
                c.prefetch_misses += 1
            c.prefetch_wait_ms += float(wait_ms)


# -- async env execution accounting ------------------------------------------


def add_env_async_steps(n: int) -> None:
    """Record ``n`` env steps served by the async shared-memory worker pool."""
    c = _COUNTERS
    if c is not None:
        with c._lock:
            c.env_steps_async += int(n)


def add_env_worker_restart(n: int = 1) -> None:
    """Record ``n`` env-worker restarts (crash or hang past the timeout)."""
    c = _COUNTERS
    if c is not None:
        with c._lock:
            c.env_worker_restarts += int(n)


def add_env_degraded(n: int = 1) -> None:
    """Record the async env pool exhausting its restart budget and degrading
    to in-process sync stepping."""
    c = _COUNTERS
    if c is not None:
        with c._lock:
            c.env_degraded_to_sync += int(n)


# -- rollout engine accounting ------------------------------------------------


def add_rollout_burst(act_dispatches: int = 1, jax_steps: int = 0) -> None:
    """Record one collection burst: ``act_dispatches`` policy calls were paid
    for it and ``jax_steps`` env steps ran on the device (``env.backend=jax``)."""
    c = _COUNTERS
    if c is not None:
        with c._lock:
            c.rollout_bursts += 1
            c.act_dispatches += int(act_dispatches)
            c.env_steps_jax += int(jax_steps)


def add_act_dispatches(n: int = 1) -> None:
    """Record ``n`` standalone policy inference dispatches (per-step acting
    paths not yet routed through a rollout burst)."""
    c = _COUNTERS
    if c is not None:
        with c._lock:
            c.act_dispatches += int(n)


# -- train-burst engine accounting --------------------------------------------


def add_train_burst(steps: int = 0, dispatches: int = 1) -> None:
    """Record one training burst: ``steps`` gradient steps were trained
    through ``dispatches`` step calls (one a gradient step in the port)."""
    c = _COUNTERS
    if c is not None:
        with c._lock:
            c.train_bursts += 1
            c.train_dispatches += int(dispatches)
            c.train_burst_steps += int(steps)


def add_learn_fetch(n: int = 1) -> None:
    """Record one learn-probe device→host pull (obs/learn.observe_probes)."""
    c = _COUNTERS
    if c is not None:
        with c._lock:
            c.learn_probe_fetches += int(n)


# -- parameter-sharding accounting -------------------------------------------


def set_shard_footprint(
    params_bytes_per_device: int,
    opt_state_bytes_per_device: int,
    model_axis_size: int = 1,
) -> None:
    """Record the per-device HBM footprint of params/optimizer state under
    the active sharding layout (gauges, set once at placement — a replicated
    run records the full tree size with ``model_axis_size=1``)."""
    c = _COUNTERS
    if c is not None:
        with c._lock:
            c.params_bytes_per_device = int(params_bytes_per_device)
            c.opt_state_bytes_per_device = int(opt_state_bytes_per_device)
            c.model_axis_size = int(model_axis_size)


# -- actor–learner plane accounting ------------------------------------------


def add_plane_slabs(n: int = 1) -> None:
    """Record ``n`` trajectory slabs received from player processes."""
    c = _COUNTERS
    if c is not None:
        with c._lock:
            c.plane_traj_slabs += int(n)


def note_plane_policy_version(version: int) -> None:
    """Record the newest published policy version (monotone gauge)."""
    c = _COUNTERS
    if c is not None:
        with c._lock:
            c.plane_policy_version = max(c.plane_policy_version, int(version))


def add_plane_player_restart(n: int = 1) -> None:
    """Record ``n`` player-process respawns (crash within the restart budget)."""
    c = _COUNTERS
    if c is not None:
        with c._lock:
            c.plane_player_restarts += int(n)


# -- sharded replay plane accounting -----------------------------------------


def add_replay_priority_updates(n: int = 1) -> None:
    """Record ``n`` priority rows rewritten by the TD-priority writeback
    channel (sheeprl_tpu_torch/replay/strategies.py)."""
    c = _COUNTERS
    if c is not None:
        with c._lock:
            c.replay_priority_updates += int(n)


def add_replay_adoption(n: int = 1) -> None:
    """Record ``n`` slabs adopted straight into the device ring
    (``DeviceRingTransitions.adopt_slab`` — no host-buffer hop)."""
    c = _COUNTERS
    if c is not None:
        with c._lock:
            c.replay_adoptions += int(n)


def set_replay_shard_fill(fills: Dict[str, float]) -> None:
    """Record the per-shard fill gauge (fraction of ring capacity holding
    data, keyed by shard index as a string)."""
    c = _COUNTERS
    if c is not None:
        with c._lock:
            c.replay_shard_fill.update({str(k): float(v) for k, v in fills.items()})


def add_kernel_tier_degraded(n: int = 1) -> None:
    """Record ``n`` fused-kernel tier auto-degrades (kernels/registry.py)."""
    c = _COUNTERS
    if c is not None:
        with c._lock:
            c.kernel_tier_degraded += int(n)


# -- checkpoint accounting --------------------------------------------------


def add_ckpt_blocked_ms(ms: float) -> None:
    """Record wall milliseconds a train step spent blocked on a checkpoint
    (host snapshot + waiting out the previous in-flight save)."""
    c = _COUNTERS
    if c is not None:
        with c._lock:
            c.ckpt_blocked_ms += float(ms)


def add_ckpt_write(ms: float, nbytes: int, failed: bool = False) -> None:
    """Record one checkpoint write (writer-thread time + bytes landed)."""
    c = _COUNTERS
    if c is not None:
        with c._lock:
            c.ckpt_write_ms += float(ms)
            c.ckpt_bytes += int(nbytes)
            if failed:
                c.ckpt_failures += 1
            else:
                c.ckpt_saves += 1


# -- evaluation accounting --------------------------------------------------


def add_eval_rounds(n: int = 1) -> None:
    """Record ``n`` eval-service rounds run in this process (evals/service)."""
    c = _COUNTERS
    if c is not None:
        with c._lock:
            c.eval_rounds += int(n)


def add_eval_episodes(n: int) -> None:
    """Record ``n`` frozen-policy eval episodes completed (evals/service)."""
    c = _COUNTERS
    if c is not None:
        with c._lock:
            c.eval_episodes += int(n)


def add_inrun_eval_publishes(n: int = 1) -> None:
    """Record ``n`` in-run eval policy publications (evals/inrun)."""
    c = _COUNTERS
    if c is not None:
        with c._lock:
            c.inrun_eval_publishes += int(n)


# -- policy-serving gateway accounting ----------------------------------------


def add_serve_requests(n: int = 1) -> None:
    """Record ``n`` act() requests accepted by the gateway (serve/batcher)."""
    c = _COUNTERS
    if c is not None:
        with c._lock:
            c.serve_requests += int(n)


def add_serve_batch(rows: int, deadline_miss: bool = False) -> None:
    """Record one coalesced batch dispatch carrying ``rows`` requests;
    ``deadline_miss`` marks a batch the dispatcher launched *after* its
    latency deadline had already expired (device busy, not a partial fill)."""
    c = _COUNTERS
    if c is not None:
        with c._lock:
            c.serve_batches += 1
            c.serve_batch_rows += int(rows)
            if deadline_miss:
                c.serve_deadline_misses += 1


def add_serve_swap(n: int = 1) -> None:
    """Record ``n`` in-place gateway model hot-swaps (serve/model)."""
    c = _COUNTERS
    if c is not None:
        with c._lock:
            c.serve_swaps += int(n)


def add_serve_failed(n: int = 1) -> None:
    """Record ``n`` failed serve requests (dispatch error or drain abandon)."""
    c = _COUNTERS
    if c is not None:
        with c._lock:
            c.serve_failed_requests += int(n)


def add_serve_traced(n: int = 1) -> None:
    """Record ``n`` requests whose span chain landed in the trace plane."""
    c = _COUNTERS
    if c is not None:
        with c._lock:
            c.serve_traced_requests += int(n)


def add_slo_alert(n: int = 1) -> None:
    """Record ``n`` SLO burn-rate alert firings (obs/slo)."""
    c = _COUNTERS
    if c is not None:
        with c._lock:
            c.slo_alerts_fired += int(n)


# -- CUDA-graph accounting (the JAX package's recompile accounting) -------


def add_graph_capture(seconds: float) -> None:
    """Record one CUDA-graph capture (``recompiles``) and the host seconds of
    its step's warm-up calls and capture (``compile_secs``); fires the
    capture hook."""
    c = _COUNTERS
    if c is None:
        return
    with c._lock:
        c.recompiles += 1
        c.compile_secs += float(seconds)
    hook = _COMPILE_HOOK
    if hook is not None:
        try:
            hook(float(seconds))
        except Exception:
            pass


def add_graph_replays(n: int = 1) -> None:
    """Record ``n`` CUDA-graph replays."""
    c = _COUNTERS
    if c is not None:
        with c._lock:
            c.graph_replays += int(n)


def add_compile_cache_hit(n: int = 1) -> None:
    """Record ``n`` kernel libraries loaded from the build directory without
    a build (``compile_cache_hits``)."""
    c = _COUNTERS
    if c is not None:
        with c._lock:
            c.compile_cache_hits += int(n)


# -- device memory ----------------------------------------------------------


def device_memory_stats(device: Any) -> Optional[Dict[str, Any]]:
    """``{"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}`` of a CUDA
    device from the caching allocator's books (``torch.cuda.memory_stats``,
    no device synchronisation) and the card's total memory; None for any
    other device."""
    try:
        import torch

        device = torch.device(device)
        if device.type != "cuda" or not torch.cuda.is_initialized():
            return None
        stats = torch.cuda.memory_stats(device)
        return {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(device).total_memory),
        }
    except Exception:
        return None


class DevicePoller:
    """Background sampler of per-device memory stats.

    Tracks the run's peak device memory (the allocator's
    ``allocated_bytes.all.peak``, which ``torch.cuda.max_memory_allocated``
    reads) and, when a tracer is active, emits one counter event per sample
    so occupancy is plottable on the same timeline as the phase spans.
    ``devices`` are the run's devices (none on a CPU run).
    """

    def __init__(self, interval_s: float = 5.0, devices: Optional[list] = None):
        self.interval_s = float(interval_s)
        self._devices = devices
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self.peak_hbm_bytes = 0
        self.hbm_bytes_limit = 0
        self.samples = 0

    def _resolve_devices(self) -> list:
        return list(self._devices or ())

    def sample_once(self) -> None:
        from sheeprl_tpu_torch.obs.spans import get_tracer

        in_use: Dict[str, float] = {}
        peak = 0
        limit = 0
        for dev in self._resolve_devices():
            stats = device_memory_stats(dev)
            if not stats:
                continue
            used = int(stats.get("bytes_in_use", 0))
            peak = max(peak, int(stats.get("peak_bytes_in_use", used)))
            limit = max(limit, int(stats.get("bytes_limit", 0)))
            in_use[str(dev)] = used
        with self._lock:
            self.samples += 1
            self.peak_hbm_bytes = max(self.peak_hbm_bytes, peak)
            self.hbm_bytes_limit = max(self.hbm_bytes_limit, limit)
        tracer = get_tracer()
        if tracer is not None and in_use:
            tracer.counter("hbm_bytes_in_use", in_use)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.sample_once()

    def start(self) -> None:
        if self.interval_s <= 0 or self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="obs-device-poller", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        # even a run shorter than one interval gets a final sample
        self.sample_once()

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "peak_hbm_bytes": self.peak_hbm_bytes,
                "hbm_bytes_limit": self.hbm_bytes_limit,
                "hbm_samples": self.samples,
            }

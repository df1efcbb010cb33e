"""The policy-serving gateway: model + batcher + transports + lifecycle
(counterpart of ``sheeprl_tpu/serve/gateway.py``).

:class:`ServeGateway` owns one :class:`~sheeprl_tpu_torch.serve.model.GatewayModel`
(from a checkpoint directory or a ``registry:best:<algo>:<env id>`` ref),
one :class:`~sheeprl_tpu_torch.serve.batcher.RequestBatcher`, and
optionally a :class:`~sheeprl_tpu_torch.serve.model.PolicySwapper` watching a
policy publication channel (``watch``) and an
:class:`~sheeprl_tpu_torch.serve.rings.ActSlabRing` pumped into the batcher
by a server thread for clients in other processes (``start_ring``).
``drain`` is the SIGTERM contract: refuse new requests, finish the queued
ones, stop the threads.

:func:`rescore_through_gateway` runs the eval service's protocol (same
pool, seed ladder and noise schedule) with every episode row behind its own
serve client, so each pool step coalesces into one dispatch: at matched
seeds it gives the eval service's returns bit for bit.

``enable_ops`` attaches the request-path ops surface
(:class:`~sheeprl_tpu_torch.serve.ops.ServeOps`: tracing, the access log,
the SLO engine, ``/metrics``, fault injection) by the ``serve.*`` knobs;
with every knob off there is none and the request path is unchanged.

This module imports no torch at import time: a spawned ring client
(``child_main``) never loads it.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Callable, Dict, Optional

import numpy as np

from sheeprl_tpu_torch.obs.reqtrace import now as _now
from sheeprl_tpu_torch.obs.reqtrace import unix_now as _unix_now
from sheeprl_tpu_torch.utils import dotdict

__all__ = ["ServeContext", "ServeGateway", "child_main", "rescore_through_gateway", "run_serve_entrypoint",
           "serve_settings"]

#: shipped defaults of the ``serve`` config group (configs/serve/default.yaml)
_SERVE_DEFAULTS: Dict[str, Any] = {
    "max_batch": 64,
    "deadline_ms": 10.0,
    "seed": 42,
    "max_clients": 1024,
    "registry_dir": "logs/registry",
    "poll_root": None,  # a policy publication dir to hot-swap from
    "poll_interval_s": 0.2,
    "drain_timeout_s": 30.0,
    "duration_s": 0.0,  # 0: serve until SIGTERM/SIGINT
    # the port's own knob, not in the shipped YAML: load clients the command spawns on its ring
    # (serve.clients.n=64 serve.clients.entry=sheeprl_tpu_torch.serve.loadgen:seeded_client serve.clients.spec.*=...)
    "clients": {"n": 0, "entry": None, "spec": {}},
    # the request-path ops surface (serve/ops.py): all off by default
    "trace_sample_rate": 0.0,
    "access_log_sample_rate": 0.0,
    "obs_dir": None,
    "metrics_port": None,
    "inject_dispatch_delay_s": 0.0,
    "slo": {
        "enabled": False,
        "objectives": {"act_latency_p99_ms": 250.0, "availability": 0.999, "swap_staleness_s": 30.0},
    },
}


def serve_settings(cfg) -> dotdict:
    """The ``serve`` knobs with the shipped defaults filled in."""
    merged = dict(_SERVE_DEFAULTS)
    try:
        user = cfg.get("serve", {}) or {}
    except AttributeError:
        user = {}
    merged.update(dict(user))
    return dotdict(merged)


class ServeGateway:
    """One serving endpoint: coalesced batched inference over one model."""

    def __init__(
        self,
        model,
        cfg=None,
        observation_space=None,
        action_space=None,
        max_batch: int = 64,
        deadline_s: float = 0.010,
        seed: int = 42,
    ):
        from sheeprl_tpu_torch.serve.batcher import RequestBatcher

        self.cfg = cfg
        self.observation_space = observation_space
        self.action_space = action_space
        self.batcher = RequestBatcher(model, max_batch=max_batch, deadline_s=deadline_s, seed=seed)
        self._swapper = None
        self._ring = None
        self._ring_stop = threading.Event()
        self._ring_thread: Optional[threading.Thread] = None
        self.ops = None

    @classmethod
    def from_checkpoint(
        cls,
        checkpoint_ref: str,
        registry_dir: str = "logs/registry",
        max_batch: int = 64,
        deadline_s: float = 0.010,
        seed: int = 42,
        device=None,
    ) -> "ServeGateway":
        """Cold start: a manifest-checked load, on ``device`` (``cuda`` when None)."""
        from sheeprl_tpu_torch.serve.model import load_gateway_model

        model, cfg, obs_space, act_space = load_gateway_model(checkpoint_ref, device=device, registry_dir=registry_dir)
        return cls(model, cfg=cfg, observation_space=obs_space, action_space=act_space, max_batch=max_batch,
                   deadline_s=deadline_s, seed=seed)

    def client(self, client_id: Optional[str] = None):
        """An in-process serve client."""
        from sheeprl_tpu_torch.serve.client import LocalServeClient

        return LocalServeClient(self.batcher, client_id=client_id)

    def enable_ops(self, settings: Dict[str, Any], out_dir: Optional[str] = None):
        """Attach the request-path ops surface (tracing, SLO engine, access
        log, ``/metrics``, fault injection) by the ``serve.*`` knobs, its
        files under ``out_dir`` (else ``serve.obs_dir``, else
        ``logs/serve_obs``). Returns the
        :class:`~sheeprl_tpu_torch.serve.ops.ServeOps`, or None when every
        knob is off: then the request path is untouched."""
        from sheeprl_tpu_torch.serve.ops import ServeOps

        if self.ops is not None:
            raise RuntimeError("gateway ops surface is already enabled")
        out = out_dir or settings.get("obs_dir", None) or "logs/serve_obs"
        self.ops = ServeOps.build(settings, str(out), status_fn=self.status, staleness_fn=self._swap_staleness)
        if self.ops is not None:
            self.batcher.attach_ops(self.ops)
            if self._ring is not None and self.ops.tracer is not None:
                self._ring.trace_every = self.ops.tracer.every
        return self.ops

    def _swap_staleness(self) -> float:
        """Seconds the serving model lags the newest publication: 0 with no
        swapper or when serving is current, else the age of the newest
        publication not yet swapped in."""
        swapper = self._swapper
        if swapper is None:
            return 0.0
        try:
            from sheeprl_tpu_torch.plane.publish import policy_path

            latest = swapper._poller.latest_version()
            if latest is None or int(latest) <= int(swapper._last_version):
                return 0.0
            mtime = os.path.getmtime(policy_path(swapper._poller.root, int(latest)))
            return max(0.0, _unix_now() - mtime)
        except Exception:
            return 0.0

    def watch(self, policy_root: str, poll_interval_s: float = 0.2):
        """Start hot-swapping from a policy publication channel."""
        from sheeprl_tpu_torch.serve.model import PolicySwapper

        if self._swapper is not None:
            raise RuntimeError("gateway is already watching a policy channel")
        self._swapper = PolicySwapper(
            policy_root,
            self.cfg,
            self.observation_space,
            self.action_space,
            swap_fn=self.batcher.swap,
            base_model=self.batcher.model,
            poll_interval_s=poll_interval_s,
        )
        return self._swapper

    def start_ring(self, n_clients: int, ctx=None):
        """Make the shared-memory ring for ``n_clients`` clients in other
        processes and start the thread that pumps it into the batcher."""
        from sheeprl_tpu_torch.serve.rings import ActSlabRing

        if self._ring is not None:
            raise RuntimeError("gateway already serves a ring")
        if self.observation_space is None or self.action_space is None:
            raise RuntimeError("ring serving needs the gateway's env spaces")
        obs_row = {k: np.zeros(s.shape, s.dtype) for k, s in self.observation_space.spaces.items()}
        act_row = np.zeros(self.action_space.shape, self.action_space.dtype)
        self._ring = ActSlabRing.from_example(obs_row, act_row, n_clients, ctx=ctx)
        if self.ops is not None and self.ops.tracer is not None:
            # the ring carries the sampling knob: a client process has no tracer, it stamps every k-th request
            self._ring.trace_every = self.ops.tracer.every
        self._ring_thread = threading.Thread(target=self._serve_ring, name="serve-ring", daemon=True)
        self._ring_thread.start()
        return self._ring

    def _serve_ring(self) -> None:
        from sheeprl_tpu_torch.serve.batcher import ServeClosed

        ring = self._ring
        while not self._ring_stop.is_set():
            requests = ring.next_requests(timeout=0.05)
            tickets = []
            for slot, seq, reset in requests:
                try:
                    ticket = self.batcher.submit(f"ring{slot}", ring.read_obs_row(slot), reset=reset,
                                                 trace=ring.read_meta(slot))
                except ServeClosed as exc:
                    ring.respond(slot, seq, None, -1, error=str(exc))
                    continue
                tickets.append((slot, seq, ticket))
            # the tickets resolve together (one coalesced dispatch covers them): waiting here keeps the pump
            # single-threaded at no extra cost
            for slot, seq, ticket in tickets:
                try:
                    action, version = self.batcher.wait(ticket, timeout=60.0)
                except Exception as exc:
                    ring.respond(slot, seq, None, -1, error=str(exc))
                    continue
                ring.respond(slot, seq, action, version)

    def status(self) -> Dict[str, Any]:
        model = self.batcher.model
        status = {
            "algo": model.algo,
            "env": model.env_id,
            "device": str(model.device),
            "model_version": int(model.version),
            "checkpoint": getattr(model, "checkpoint", None),
            "swapper": self._swapper is not None,
            **self.batcher.stats(),
        }
        ops = self.ops
        if ops is not None:
            if ops.tracer is not None:
                status["trace"] = {"sample_rate": float(ops.tracer.sample_rate),
                                   "sampled_requests": int(ops.tracer.sampled)}
            if ops.slo is not None:
                status["slo"] = ops.slo.status()
        return status

    def drain(self, timeout: float = 30.0) -> bool:
        """The SIGTERM path: finish the queued requests (those still queued
        at ``timeout`` fail loudly), then stop everything. True when the
        queue drained in time."""
        drained = self.batcher.drain(timeout=timeout)
        self._shutdown_aux()
        return drained

    def close(self) -> None:
        self.batcher.close()
        self._shutdown_aux()

    def _shutdown_aux(self) -> None:
        if self.ops is not None:  # its last tick and snapshot read the batcher's final stats
            self.ops.close()
            self.ops = None
        if self._swapper is not None:
            self._swapper.close()
            self._swapper = None
        self._ring_stop.set()
        if self._ring_thread is not None:
            self._ring_thread.join(timeout=10.0)
            self._ring_thread = None
        if self._ring is not None:
            self._ring.close()


class ServeContext:
    """What a spawned client process needs (it pickles): the ring, the
    client's slot and a ``module:function`` entry called as
    ``entry(client, spec)``."""

    def __init__(self, ring, slot: int, entry: str, spec: Optional[Dict[str, Any]] = None):
        self.ring = ring
        self.slot = int(slot)
        self.entry = str(entry)
        self.spec = dict(spec or {})


def child_main(ctx: ServeContext) -> None:
    """A client process's entry point (spawned, never forked: the server has
    a CUDA context). It loads no torch."""
    import importlib

    from sheeprl_tpu_torch.serve.client import RingServeClient

    module_name, _, fn_name = ctx.entry.partition(":")
    fn = getattr(importlib.import_module(module_name), fn_name)
    fn(RingServeClient(ctx.ring, ctx.slot), ctx.spec)


def spawn_clients(ring, n: int, entry: str, spec: Optional[Dict[str, Any]] = None) -> list:
    """Start ``n`` client processes (spawned) on slots 0..n-1 of ``ring``."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [
        ctx.Process(target=child_main, args=(ServeContext(ring, slot, entry, spec),), daemon=True,
                    name=f"serve-client-{slot}")
        for slot in range(int(n))
    ]
    for p in procs:
        p.start()
    return procs


# ---------------------------------------------------------------------------
# the gateway-path rescore
# ---------------------------------------------------------------------------


def rescore_through_gateway(
    checkpoint_ref: str,
    episodes: int = 10,
    seed0: int = 1000,
    registry_dir: str = "logs/registry",
    max_steps: int = 0,
    device=None,
    on_step: Optional[Callable[[np.ndarray], None]] = None,
) -> Dict[str, Any]:
    """The frozen-greedy protocol with every episode row behind a serve
    client: same pool, seed ladder and noise schedule as
    :func:`~sheeprl_tpu_torch.evals.service.run_parallel_episodes`, one full
    coalesced batch a pool step, so matched seeds give the eval service's
    returns bit for bit. ``on_step(actions)`` sees each step's actions.
    Returns the eval-shaped result and the gateway's ``versions_served``,
    ``batches``, occupancy and failures."""
    from sheeprl_tpu_torch.evals.service import eval_settings, iqm, make_eval_pool

    n = int(episodes)
    gateway = ServeGateway.from_checkpoint(
        checkpoint_ref,
        registry_dir=registry_dir,
        max_batch=n,  # every pool step coalesces into exactly one dispatch
        deadline_s=5.0,
        seed=int(seed0),  # the eval runner's generator seed
        device=device,
    )
    try:
        cfg = gateway.cfg
        max_steps = int(max_steps or eval_settings(cfg).max_steps or 0)
        pool, seeds = make_eval_pool(cfg, None, n, int(seed0), prefix="serve")
        try:
            act_shape = tuple(pool.single_action_space.shape)
            clients = [gateway.client(f"episode{i}") for i in range(n)]
            obs, _ = pool.reset(seed=[int(s) for s in seeds])
            returns = np.zeros(n, dtype=np.float64)
            lengths = np.zeros(n, dtype=np.int64)
            alive = np.ones(n, dtype=bool)
            need_reset = np.zeros(n, dtype=bool)
            steps = 0
            while alive.any():
                tickets = [
                    gateway.batcher.submit(c.client_id, {k: np.asarray(v[i]) for k, v in obs.items()},
                                           reset=bool(need_reset[i]))
                    for i, c in enumerate(clients)
                ]
                rows = [gateway.batcher.wait(t, timeout=60.0) for t in tickets]
                real_actions = np.stack([np.asarray(a) for a, _v in rows]).reshape((n,) + act_shape)
                if on_step is not None:
                    on_step(real_actions)
                obs, rewards, terminated, truncated, _ = pool.step(real_actions)
                done = np.logical_or(np.asarray(terminated).reshape(n), np.asarray(truncated).reshape(n))
                returns += np.asarray(rewards, dtype=np.float64).reshape(n) * alive
                lengths += alive.astype(np.int64)
                alive &= ~done
                # a finished row re-enters through the autoreset: a fresh state then, as the runner resets it
                need_reset = done.copy()
                steps += 1
                if max_steps and steps >= max_steps:
                    break
        finally:
            pool.close()
        stats = gateway.batcher.stats()
        model = gateway.batcher.model
        return {
            "protocol": "frozen-greedy/gateway",
            "checkpoint": getattr(model, "checkpoint", None),
            "algo": model.algo,
            "env": model.env_id,
            "n": n,
            "seed0": int(seed0),
            "seeds": [int(s) for s in seeds],
            "returns": [float(r) for r in returns],
            "lengths": [int(x) for x in lengths],
            "mean": float(np.mean(returns)),
            "std": float(np.std(returns)),
            "iqm": iqm(returns),
            "versions_served": stats["versions_served"],
            "batches": stats["batches"],
            "mean_batch_occupancy": stats["mean_batch_occupancy"],
            "failed_requests": stats["failed_requests"],
        }
    finally:
        gateway.close()


# ---------------------------------------------------------------------------
# the serve command's body
# ---------------------------------------------------------------------------


def _launch_counts() -> Dict[str, int]:
    from sheeprl_tpu_torch.kernels import ops

    return {"hafner_cell": ops.hafner_cell_launches.count, "hafner_sequence": ops.hafner_sequence_launches.count}


def run_serve_entrypoint(serve_cfg) -> Dict[str, Any]:
    """The ``cli.serve`` body: build the gateway (on ``fabric.accelerator``,
    ``cuda`` by default), hot-swap when ``serve.poll_root`` is set, serve
    the ring (and spawn ``serve.clients.n`` load clients on it), and drain
    on SIGTERM/SIGINT or after ``serve.duration_s``. Returns the final
    status, also printed as the ``[serve] final`` line."""
    import signal

    settings = serve_settings(serve_cfg)
    accelerator = str((serve_cfg.get("fabric", None) or {}).get("accelerator", "auto") or "auto").lower()
    gateway = ServeGateway.from_checkpoint(
        serve_cfg.checkpoint_path,
        registry_dir=str(settings.registry_dir),
        max_batch=int(settings.max_batch),
        deadline_s=float(settings.deadline_ms) / 1e3,
        seed=int(settings.seed),
        device="cpu" if accelerator == "cpu" else None,
    )
    procs, previous = [], {}
    try:
        ops = gateway.enable_ops(settings)
        if settings.poll_root:
            gateway.watch(str(settings.poll_root), poll_interval_s=float(settings.poll_interval_s))
        clients = dotdict(settings.clients or {})
        n_clients = int(clients.get("n", 0) or 0)
        ring = gateway.start_ring(max(int(settings.max_clients), n_clients))
        status = gateway.status()
        print(
            f"[serve] gateway up: {status['algo']} on {status['env']} v{status['model_version']} "
            f"({status['device']}, max_batch={settings.max_batch}, deadline={settings.deadline_ms}ms, "
            f"max_clients={settings.max_clients})",
            flush=True,
        )
        if ops is not None:
            port = ops.prom.port if ops.prom is not None else None
            print(
                f"[serve] ops surface on: dir={ops.out_dir} trace_rate={settings.trace_sample_rate} "
                f"access_rate={settings.access_log_sample_rate} slo={'on' if ops.slo is not None else 'off'} "
                f"metrics_port={port} inject_dispatch_delay_s={ops.inject_dispatch_delay_s}",
                flush=True,
            )
        if n_clients:
            procs = spawn_clients(ring, n_clients, str(clients.entry), dict(clients.get("spec", None) or {}))

        stop = threading.Event()

        def _on_term(_signum, _frame):
            stop.set()

        # handlers can only be installed from the main thread (elsewhere duration_s ends the serving); the
        # caller's come back after the drain
        if threading.current_thread() is threading.main_thread():
            previous = {sig: signal.signal(sig, _on_term) for sig in (signal.SIGTERM, signal.SIGINT)}
        t_up = _now()
        deadline = t_up + float(settings.duration_s) if settings.duration_s else None
        while not stop.is_set():
            if deadline is not None and _now() >= deadline:
                break
            stop.wait(timeout=min(5.0, max(deadline - _now(), 0.0)) if deadline is not None else 5.0)
            s = gateway.status()
            print(
                f"[serve] v{s['model_version']} requests={s['requests']} batches={s['batches']} "
                f"occupancy={s['mean_batch_occupancy']} p99={s['act_latency'].get('p99_ms')}ms swaps={s['swaps']} "
                f"failed={s['failed_requests']}",
                flush=True,
            )
        serving_s = _now() - t_up
        t0 = _now()
        drained = gateway.drain(timeout=float(settings.drain_timeout_s))
        drain_s = _now() - t0
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
        gateway.close()
        for p in procs:
            p.join(timeout=10.0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
    final = {**gateway.status(), "drained": drained, "serving_s": serving_s, "drain_s": drain_s,
             "kernel_launches": _launch_counts()}
    print(f"[serve] drained={'clean' if drained else 'TIMEOUT'}; gateway down", flush=True)
    print("[serve] final " + json.dumps(final, default=str), flush=True)
    return final

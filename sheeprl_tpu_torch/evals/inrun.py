"""Periodic in-run evaluation, off the training step's path (counterpart of
``sheeprl_tpu/evals/inrun.py``).

The trainer never plays an eval episode. Every ``eval.every_n_steps``
policy steps it publishes the acting modules (world model and actor, copied
to the host) through an asynchronous
:class:`~sheeprl_tpu_torch.plane.publish.PolicyPublisher`. A separate
**eval process**, spawned (never forked: the trainer holds a CUDA context),
polls the channel with a
:class:`~sheeprl_tpu_torch.plane.publish.PolicyPoller`, rebuilds the policy
with the family's registered eval builder, plays ``eval.inrun_episodes``
frozen-greedy episodes and writes the growing curve to
``<log_dir>/telemetry/sidecar_evalproc.json``.

The child runs on the CPU with ``device="cpu"``, as the JAX child pins
itself to the CPU backend, so that it never competes with the trainer for
the device; it never initialises CUDA, and says so in its sidecar
(``cuda_initialized``). It runs at ``SCHED_IDLE`` (``nice(19)`` where that
is refused), so it takes only the CPU time the trainer leaves.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

__all__ = ["InRunEval", "child_main", "maybe_start_inrun_eval"]


class _ChildHalt:
    """``stop`` set, or the parent gone: the child's blocking waits end."""

    def __init__(self, stop, parent_pid: int):
        self._stop = stop
        self._parent_pid = int(parent_pid)

    def is_set(self) -> bool:
        return (self._stop is not None and self._stop.is_set()) or os.getppid() != self._parent_pid


def child_main(spec: Dict[str, Any]) -> None:
    """The eval process's entry point."""
    try:
        os.sched_setscheduler(0, os.SCHED_IDLE, os.sched_param(0))
    except (AttributeError, OSError):
        try:
            os.nice(19)
        except OSError:
            pass

    import numpy as np
    import torch

    from sheeprl_tpu_torch.evals.service import _builder_for, make_eval_pool, probe_spaces, run_parallel_episodes
    from sheeprl_tpu_torch.obs.dist.aggregate import write_sidecar
    from sheeprl_tpu_torch.plane.publish import PlaneClosed, PolicyPoller
    from sheeprl_tpu_torch.utils import dotdict

    cfg = dotdict(spec["cfg"])
    cfg.env.capture_video = False
    cfg["eval"] = {**dict(cfg.get("eval", {}) or {}), "vectorization": "sync"}  # a daemonic child has no worker pools
    halt = _ChildHalt(spec.get("stop"), spec["parent_pid"])
    episodes = max(int(spec.get("episodes", 2)), 1)
    seed0 = int(spec.get("seed0", 1000))
    tel_dir = spec["tel_dir"]
    try:
        builder = _builder_for(cfg.algo.name)
    except RuntimeError as exc:
        write_sidecar(tel_dir, "evalproc", {"error": str(exc), "points": []})
        return

    observation_space, action_space = probe_spaces(cfg)
    pool, seeds = make_eval_pool(cfg, None, episodes, seed0, prefix="inrun")
    act_shape = tuple(pool.single_action_space.shape)
    poller = PolicyPoller(spec["policy_root"])
    points = []
    try:
        version = -1
        while True:
            # the newest version past the last one scored; once stopped, a version published before the stop
            # is still scored, then the wait raises
            try:
                version, params = poller.wait_min_version(version + 1, stop=halt, use_exact=False)
            except PlaneClosed:
                break
            t0 = time.monotonic()
            # the CPU, explicitly: the child must never compete with the trainer for the device
            policy = builder(None, cfg, params, observation_space, action_space, device="cpu")
            returns, _lengths = run_parallel_episodes(
                policy,
                pool,
                seeds,
                torch.Generator(device="cpu").manual_seed(seed0),
                act_shape,
                max_steps=int(cfg["eval"].get("max_steps", 0) or 0),
            )
            points.append(
                {
                    "policy_version": int(version),
                    "mean": float(np.mean(returns)),
                    "std": float(np.std(returns)),
                    "episodes": episodes,
                    "eval_wall_s": round(time.monotonic() - t0, 3),
                }
            )
            write_sidecar(
                tel_dir,
                "evalproc",
                {
                    "protocol": "frozen-greedy",
                    "episodes": episodes,
                    "seed0": seed0,
                    "rounds": len(points),
                    "points": points[-200:],
                    "last_mean": points[-1]["mean"],
                    "last_policy_version": points[-1]["policy_version"],
                    "cuda_initialized": torch.cuda.is_initialized(),
                },
            )
    finally:
        pool.close()


class InRunEval:
    """The trainer's handle: step-gated asynchronous publication and the
    eval process."""

    def __init__(self, cfg, log_dir: str):
        import multiprocessing as mp

        from sheeprl_tpu_torch.evals.service import eval_settings
        from sheeprl_tpu_torch.plane.publish import PolicyPublisher

        settings = eval_settings(cfg)
        self.every_n_steps = int(settings.every_n_steps)
        self.policy_root = os.path.join(log_dir, "inrun_policies")
        self.tel_dir = os.path.join(log_dir, "telemetry")
        self.publishes = 0
        self._last_version: Optional[int] = None
        self._publisher = PolicyPublisher(self.policy_root, keep_policies=2, algo=str(cfg.algo.name),
                                          async_publish=True)
        ctx = mp.get_context("spawn")
        self._stop = ctx.Event()
        spec = {
            "cfg": dict(cfg),
            "policy_root": self.policy_root,
            "tel_dir": self.tel_dir,
            "episodes": int(settings.inrun_episodes),
            "seed0": int(settings.seed0),
            "stop": self._stop,
            "parent_pid": os.getpid(),
        }
        self._child = ctx.Process(target=child_main, args=(spec,), daemon=True, name="inrun-eval")
        self._child.start()

    def due(self, policy_step: int) -> bool:
        """Whether a publication at ``policy_step`` would go out."""
        policy_step = int(policy_step)
        return self._last_version is None or (
            policy_step - self._last_version >= self.every_n_steps and policy_step > self._last_version
        )

    def maybe_publish(self, policy_step: int, state: Any) -> bool:
        """Publish ``state`` (the checkpoint layout the family's builder
        reads: ``{"agent": {"world_model": ..., "actor": ...}}``, tensors) as
        version ``policy_step`` when due; True when published. The tensors
        are copied to the host here, after the device has finished the work
        queued so far, so the copy never reads a graph's static tensors
        while a replay writes them."""
        import torch

        from sheeprl_tpu_torch.ckpt.manager import host_snapshot

        if not self.due(policy_step):
            return False
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self._publisher.publish(int(policy_step), host_snapshot(state))
        self._last_version = int(policy_step)
        self.publishes += 1
        return True

    def close(self, timeout: float = 60.0) -> None:
        """Flush pending publications, then stop the eval process: it scores
        the newest version published before the stop (``timeout`` seconds at
        most), then exits."""
        try:
            self._publisher.close(timeout=timeout)
        finally:
            self._stop.set()
            self._child.join(timeout=timeout)
            if self._child.is_alive():
                self._child.terminate()
                self._child.join(timeout=5.0)


def maybe_start_inrun_eval(fabric, cfg, log_dir: Optional[str]) -> Optional[InRunEval]:
    """The one call a training loop makes: a handle when in-run evaluation
    is on (``eval.every_n_steps > 0``) on global rank 0, else None."""
    from sheeprl_tpu_torch.evals.service import eval_settings

    if int(eval_settings(cfg).every_n_steps or 0) <= 0 or not log_dir:
        return None
    if fabric is not None and not getattr(fabric, "is_global_zero", True):
        return None
    return InRunEval(cfg, log_dir)

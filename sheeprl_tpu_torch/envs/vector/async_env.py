"""The fault-tolerant shared-memory worker pool (counterpart of
``sheeprl_tpu/envs/vector/async_env.py``), ``env.vectorization=async``.

Every env runs in a worker process of its own and writes its step straight
into the preallocated blocks of
:class:`~sheeprl_tpu_torch.envs.vector.shmem.SharedStepSlabs`, in the
``[num_envs, ...]`` layout the replay buffers consume. ``step()`` returns
numpy *views* of the current slot: no copy between an env writing an
observation and the buffer's ``add`` (the slabs are double-buffered, so the
previous step's views stay valid).

Its semantics are bitwise those of
:class:`~sheeprl_tpu_torch.envs.vector.sync_env.SyncVectorEnv`: the same
per-env seeding, ``SAME_STEP`` autoreset with ``final_obs``/``final_info``,
and ``_``-masked infos.

A worker gets its env as a thunk that pickles with the standard pickle (no
cloudpickle: the port's ``make_env`` gives a ``partial`` of a module-level
builder over the plain config, the seed and the index, so an
``env.wrapper._target_`` such as ``chip_smoke.cartpole_stand_in`` is
resolved inside the worker). Workers start with ``forkserver`` (or
``spawn``), never ``fork``: the learner holds a CUDA context.

Faults:

- a worker that crashes (the env raises, the process dies) or hangs past
  ``worker_timeout_s`` (a deadline on the whole step) is killed and
  restarted, and the lost step becomes an auto-reset of that env: reward 0,
  neither terminated nor truncated, ``info["env_worker_restart"]`` set;
- restarts are bounded: more than ``max_worker_restarts`` inside a sliding
  ``restart_window_s`` and the pool **degrades to sync**: every worker is
  torn down and the envs are rebuilt in this process and stepped serially;
- with ``restart_workers=False`` (``gym_async``) a worker fault raises;
- workers ignore SIGTERM and SIGINT (the parent owns the preemption drain);
  ``close()`` asks them to exit and waits a short budget (2 s under a
  preemption, 10 s otherwise) before killing them.

The wait for the workers' replies is the ``Time/env_wait_time`` span. With
the run telemetry on, the pool counts its async steps, restarts and degrade
(``obs/counters.py``), fires the flight recorder's ``env_worker_restart``
and ``env_degrade_sync``, and at its close publishes its per-worker steps
and restarts as a telemetry source (``envpool_<pid>``; inside a plane player
it rides in the player's sidecar).
"""

from __future__ import annotations

import atexit
import multiprocessing
import os
import time
import warnings
import weakref
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from sheeprl_tpu_torch.envs.spaces import batch_space
from sheeprl_tpu_torch.envs.vector.shmem import N_SLOTS, SharedStepSlabs
from sheeprl_tpu_torch.envs.vector.sync_env import add_final, add_info, expand_seeds
from sheeprl_tpu_torch.obs import counters as _counters
from sheeprl_tpu_torch.obs.spans import span
from sheeprl_tpu_torch.utils.metric import SumMetric

__all__ = ["AsyncSharedMemVectorEnv"]

#: extra patience for a worker's start (imports and the env's build dominate)
_BOOT_TIMEOUT_FLOOR_S = 120.0
#: seed offset a restart adds, so that a rebuilt env does not replay the episode that crashed it
_RESTART_SEED_STRIDE = 1_000_003


def _close_at_exit(env_ref) -> None:
    """An interpreter exiting with the pool open must not hang: the workers
    ignore SIGTERM, so multiprocessing's own exit handler (which terminates,
    then joins without a timeout) would wait forever. Registered after it,
    so it runs first."""
    env = env_ref()
    if env is not None:
        try:
            env.close()
        except Exception:
            pass


def _write(views, slot: int, index: int, obs, reward: float, terminated: bool, truncated: bool) -> None:
    obs_view, rew_view, term_view, trunc_view = views
    for key, arr in obs_view.items():
        arr[slot, index] = obs[key]
    rew_view[slot, index] = reward
    term_view[slot, index] = terminated
    trunc_view[slot, index] = truncated


def _flight(reason: str, detail: Dict[str, Any]) -> None:
    """Fire the run's flight recorder (a no-op with the telemetry off)."""
    from sheeprl_tpu_torch.obs.telemetry import get_telemetry

    telemetry = get_telemetry()
    if telemetry is not None and telemetry.flight is not None:
        telemetry.flight.trigger(reason, detail)


def _worker(index: int, thunk: Callable, conn, slabs: SharedStepSlabs) -> None:
    """Build the env, then serve ``reset``/``step`` commands, writing each
    result into the slot the parent names, until ``close``."""
    import signal

    try:
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        signal.signal(signal.SIGINT, signal.SIG_IGN)
    except (ValueError, OSError):  # pragma: no cover - not the main thread
        pass
    env = None
    try:
        env = thunk()
        views = slabs.views()
        conn.send(("ready", None, None, None))
        while True:
            cmd, payload = conn.recv()
            if cmd == "close":
                break
            slot = payload["slot"]
            if cmd == "reset":
                obs, info = env.reset(seed=payload["seed"], options=payload["options"])
                _write(views, slot, index, obs, 0.0, False, False)
                conn.send(("ok", info, None, None))
            elif cmd == "step":
                obs, reward, terminated, truncated, info = env.step(payload["action"])
                final_obs = final_info = None
                if terminated or truncated:
                    # SAME_STEP: the episode's last obs and info travel in the reply, the slab gets the reset obs
                    final_obs, final_info = obs, info
                    obs, info = env.reset()
                _write(views, slot, index, obs, reward, terminated, truncated)
                conn.send(("ok", info, final_obs, final_info))
            else:  # pragma: no cover - a protocol fault
                raise RuntimeError(f"unknown worker command {cmd!r}")
    except (KeyboardInterrupt, SystemExit):  # pragma: no cover
        pass
    except Exception as exc:
        try:
            conn.send(("error", f"{type(exc).__name__}: {exc}", None, None))
        except (BrokenPipeError, OSError):
            pass
    finally:
        if env is not None:
            try:
                env.close()
            except Exception:
                pass
        try:
            conn.close()
        except OSError:
            pass


class AsyncSharedMemVectorEnv:
    """One worker process an env, shared-memory steps, bounded restarts and
    the degrade to sync.

    ``env_fns``: picklable env thunks. ``env_seeds``: the factory's per-env
    seeds, offset per restart for the rebuilt env. ``context``: the start
    method (``forkserver`` or ``spawn``). ``worker_timeout_s``: the deadline
    of a whole step, after which a worker that has not answered counts as
    hung (``<= 0`` turns it off). ``max_worker_restarts`` inside a sliding
    ``restart_window_s`` (``<= 0``: over the pool's life): one more fault
    degrades the pool to in-process stepping. ``restart_workers=False``
    raises on the first fault instead."""

    def __init__(
        self,
        env_fns: Sequence[Callable],
        env_seeds: Optional[Sequence[int]] = None,
        context: str = "forkserver",
        worker_timeout_s: float = 60.0,
        max_worker_restarts: int = 3,
        restart_window_s: float = 300.0,
        restart_workers: bool = True,
    ):
        if context == "fork":
            raise ValueError("env.mp_context=fork: the worker pool starts with forkserver or spawn, never fork "
                             "(the learner process holds a CUDA context)")
        self.env_fns = list(env_fns)
        self.num_envs = len(self.env_fns)
        self.worker_timeout_s = float(worker_timeout_s)
        self.max_worker_restarts = int(max_worker_restarts)
        self.restart_window_s = float(restart_window_s)
        self.restart_workers = bool(restart_workers)
        self._restart_times: deque = deque()
        self._env_seeds = list(env_seeds) if env_seeds is not None else [None] * self.num_envs
        self._ctx = multiprocessing.get_context(context)

        # the spaces from a probe env built and closed here: the slabs exist before any worker starts
        probe = self.env_fns[0]()
        self.single_observation_space = probe.observation_space
        self.single_action_space = probe.action_space
        probe.close()
        self.observation_space = batch_space(self.single_observation_space, self.num_envs)
        self.action_space = batch_space(self.single_action_space, self.num_envs)

        self._slabs = SharedStepSlabs(self._ctx, self.single_observation_space, self.num_envs)
        self._views = self._slabs.views()
        self._slot = 0
        #: lifetime restarts, and whether the pool degraded
        self.worker_restarts = 0
        self.degraded_to_sync = False
        #: the pool's steps (each steps every env) and its name as a telemetry source
        self.steps = 0
        self.pool_name = f"envpool_{os.getpid()}"
        self._sync_envs: Optional[List[Any]] = None
        self._closed = False
        self._procs: List[Optional[Any]] = [None] * self.num_envs
        self._conns: List[Optional[Any]] = [None] * self.num_envs
        self._restart_counts = [0] * self.num_envs
        boot = max(self.worker_timeout_s, _BOOT_TIMEOUT_FLOOR_S)
        try:
            for i in range(self.num_envs):
                self._spawn_worker(i)
            for i in range(self.num_envs):
                self._await_ready(i, boot)
        except BaseException:
            self._closed = True
            for i in range(self.num_envs):
                self._kill_worker(i)
            raise
        atexit.register(_close_at_exit, weakref.ref(self))

    # -- workers --------------------------------------------------------------

    def _spawn_worker(self, index: int) -> None:
        parent_conn, child_conn = self._ctx.Pipe(duplex=True)
        proc = self._ctx.Process(target=_worker, name=f"vecenv-worker-{index}",
                                 args=(index, self.env_fns[index], child_conn, self._slabs), daemon=True)
        proc.start()
        child_conn.close()
        self._procs[index], self._conns[index] = proc, parent_conn

    def _await_ready(self, index: int, timeout_s: float) -> None:
        conn = self._conns[index]
        if not conn.poll(timeout_s):
            raise TimeoutError(f"async env worker {index} did not come up within {timeout_s:.0f}s")
        try:
            msg = conn.recv()
        except (EOFError, OSError) as exc:
            raise RuntimeError(f"async env worker {index} died during its start (an import or the env's build "
                               "failed: run with env.vectorization=sync to see the traceback)") from exc
        if msg[0] != "ready":
            raise RuntimeError(f"async env worker {index} failed during its start: {msg[1]}")

    def _kill_worker(self, index: int) -> None:
        proc, conn = self._procs[index], self._conns[index]
        self._procs[index] = self._conns[index] = None
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass
        if proc is not None and proc.is_alive():
            # the workers ignore SIGTERM: kill outright (the revive or the degrade rewrites its slab slot)
            proc.kill()
            proc.join(timeout=2.0)

    def _restart_seed(self, index: int) -> Optional[int]:
        seed = self._env_seeds[index]
        return None if seed is None else int(seed) + self._restart_counts[index] * _RESTART_SEED_STRIDE

    def _note_restart(self, index: int, reason: str) -> None:
        now = time.monotonic()
        self._restart_times.append(now)
        if self.restart_window_s > 0:
            # a sliding window: only faults clustered inside it spend the budget
            while self._restart_times and now - self._restart_times[0] > self.restart_window_s:
                self._restart_times.popleft()
        self.worker_restarts += 1
        self._restart_counts[index] += 1
        _counters.add_env_worker_restart()
        warnings.warn(f"async env worker {index} {reason}; restart {len(self._restart_times)}/"
                      f"{self.max_worker_restarts} in window (an auto-reset replaces the lost step)")
        _flight("env_worker_restart", {"worker": index, "reason": reason, "restarts": self.worker_restarts,
                                       "restarts_in_window": len(self._restart_times),
                                       "max_worker_restarts": self.max_worker_restarts})

    def _restart_budget_exhausted(self) -> bool:
        used = len(self._restart_times) if self.restart_window_s > 0 else self.worker_restarts
        return used > self.max_worker_restarts

    def _revive_worker(self, index: int, slot: int) -> Dict[str, Any]:
        """Replace a dead or hung worker and fill its slot with a reset
        observation; returns the step's info."""
        self._kill_worker(index)
        self._spawn_worker(index)
        boot = max(self.worker_timeout_s, _BOOT_TIMEOUT_FLOOR_S)
        self._await_ready(index, boot)
        conn = self._conns[index]
        conn.send(("reset", {"seed": self._restart_seed(index), "options": None, "slot": slot}))
        if not conn.poll(boot):
            raise TimeoutError(f"restarted env worker {index} hung on its first reset")
        msg = conn.recv()
        if msg[0] != "ok":
            raise RuntimeError(f"restarted env worker {index} failed its first reset: {msg[1]}")
        info = dict(msg[1] or {})
        info["env_worker_restart"] = True
        return info

    def _degrade_to_sync(self, reason: str) -> None:
        warnings.warn(f"async env pool exceeded its restart budget ({self.max_worker_restarts}): degrading to "
                      f"in-process sync stepping ({reason}); every env is auto-reset in place of the lost step")
        for i in range(self.num_envs):
            self._kill_worker(i)
        self.degraded_to_sync = True
        _counters.add_env_degraded()
        _flight("env_degrade_sync", {"reason": reason, "restarts": self.worker_restarts})
        self._sync_envs = [fn() for fn in self.env_fns]
        for i, env in enumerate(self._sync_envs):
            # a new restart generation for every env: its first seed would replay trajectories already stored
            self._restart_counts[i] += 1
            obs, _ = env.reset(seed=self._restart_seed(i))
            _write(self._views, self._slot, i, obs, 0.0, False, False)

    def _step_sync(self, actions: np.ndarray) -> Dict[int, Tuple]:
        """The degraded pool: the same slabs and autoreset, stepped serially here."""
        slot, results = self._slot, {}
        for i, env in enumerate(self._sync_envs):
            obs, reward, terminated, truncated, info = env.step(actions[i])
            final_obs = final_info = None
            if terminated or truncated:
                final_obs, final_info = obs, info
                obs, info = env.reset()
            _write(self._views, slot, i, obs, reward, terminated, truncated)
            results[i] = (info, final_obs, final_info)
        return results

    # -- the vector env -------------------------------------------------------

    def reset(self, *, seed=None, options: Optional[Dict[str, Any]] = None):
        """``seed``: None, an int (env ``i`` gets ``seed + i``) or one seed an env."""
        self._assert_open()
        seeds = expand_seeds(seed, self.num_envs)
        # flip the slot as step does, so that a preceding step's views survive a reset too
        self._slot = (self._slot + 1) % N_SLOTS
        slot, infos = self._slot, {}
        if self._sync_envs is not None:
            for i, env in enumerate(self._sync_envs):
                obs, info = env.reset(seed=seeds[i], options=options)
                _write(self._views, slot, i, obs, 0.0, False, False)
                infos = add_info(infos, info, i, self.num_envs)
        else:
            for i in range(self.num_envs):
                self._conns[i].send(("reset", {"seed": seeds[i], "options": options, "slot": slot}))
            results = self._collect(slot)
            for i in range(self.num_envs):
                infos = add_info(infos, results[i][0], i, self.num_envs)
        return self._slot_obs(slot), infos

    def step(self, actions):
        self._assert_open()
        actions = np.asarray(actions)
        self._slot = (self._slot + 1) % N_SLOTS
        slot = self._slot
        if self._sync_envs is not None:
            results = self._step_sync(actions)
        else:
            for i in range(self.num_envs):
                self._conns[i].send(("step", {"action": np.asarray(actions[i]), "slot": slot}))
            results = self._collect(slot)
            _counters.add_env_async_steps(self.num_envs)
        self.steps += 1
        infos: Dict[str, Any] = {}
        for i in range(self.num_envs):
            info, final_obs, final_info = results[i]
            if final_obs is not None or final_info is not None:
                infos = add_final(infos, i, self.num_envs, final_obs, final_info)
            infos = add_info(infos, info, i, self.num_envs)
        _, rew, term, trunc = self._views
        return self._slot_obs(slot), np.copy(rew[slot]), np.copy(term[slot]), np.copy(trunc[slot]), infos

    def _collect(self, slot: int) -> Dict[int, Tuple]:
        """One reply a worker under the step's deadline; crashed or hung
        workers are revived (their step replaced by the auto-reset), or the
        pool degrades past the budget."""
        deadline = time.perf_counter() + self.worker_timeout_s if self.worker_timeout_s > 0 else None
        results: Dict[int, Tuple] = {}
        failed: List[Tuple[int, str]] = []
        with span("Time/env_wait_time", SumMetric(), phase="env_wait"):
            for i in range(self.num_envs):
                conn = self._conns[i]
                remaining = None if deadline is None else max(deadline - time.perf_counter(), 0.0)
                try:
                    if remaining is not None and not conn.poll(remaining):
                        failed.append((i, "hung past worker_timeout_s"))
                        continue
                    msg = conn.recv()
                except (EOFError, BrokenPipeError, ConnectionResetError, OSError):
                    failed.append((i, "process died"))
                    continue
                if msg[0] == "ok":
                    results[i] = (msg[1], msg[2], msg[3])
                else:
                    failed.append((i, f"env raised ({msg[1]})"))
        if failed and not self.restart_workers:
            i, reason = failed[0]
            raise RuntimeError(f"async env worker {i}: {reason}")
        for i, reason in failed:
            self._note_restart(i, reason)
            if self._restart_budget_exhausted():
                self._degrade_to_sync(reason)
            else:
                try:
                    results[i] = (self._revive_worker(i, slot), None, None)
                    continue
                except Exception as exc:
                    self._degrade_to_sync(f"worker {i} restart failed: {exc}")
            # the degrade reset every env into the current slot: each reports the restart step
            return {j: ({"env_worker_restart": True}, None, None) for j in range(self.num_envs)}
        return results

    def _slot_obs(self, slot: int) -> Dict[str, np.ndarray]:
        """Views of the shared slot, ``[num_envs, ...]`` a key."""
        return {key: arr[slot] for key, arr in self._views[0].items()}

    def _assert_open(self) -> None:
        if self._closed:
            raise RuntimeError("AsyncSharedMemVectorEnv is closed")

    # -- teardown -------------------------------------------------------------

    def close(self, **kwargs) -> None:
        if self._closed:
            return
        self._closed = True
        self._publish_pool_source()
        if self._sync_envs is not None:
            for env in self._sync_envs:
                try:
                    env.close()
                except Exception:
                    pass
            self._sync_envs = None
            return
        from sheeprl_tpu_torch.ckpt.preemption import preemption_requested

        # under a preemption the grace window belongs to the final checkpoint
        deadline = time.perf_counter() + (2.0 if preemption_requested() else 10.0)
        for conn in self._conns:
            if conn is not None:
                try:
                    conn.send(("close", {}))
                except (BrokenPipeError, OSError):
                    pass
        for proc in self._procs:
            remaining = deadline - time.perf_counter()
            if proc is not None and remaining > 0:
                proc.join(timeout=remaining)
        for i in range(self.num_envs):
            self._kill_worker(i)

    def _publish_pool_source(self) -> None:
        """This pool's per-worker steps and restarts into the process's
        telemetry sources (``obs/dist/aggregate``), and a sidecar when the
        run telemetry has a run directory; nothing with the telemetry off."""
        from sheeprl_tpu_torch.obs.telemetry import get_telemetry

        telemetry = get_telemetry()
        if telemetry is None and _counters.installed() is None:
            return
        from sheeprl_tpu_torch.obs.dist import aggregate as _aggregate

        snap = {
            "num_envs": self.num_envs,
            "worker_restarts": self.worker_restarts,
            "degraded_to_sync": bool(self.degraded_to_sync),
            "workers": {str(i): {"steps": self.steps, "restarts": int(self._restart_counts[i])}
                        for i in range(self.num_envs)},
        }
        try:
            _aggregate.publish_source(self.pool_name, snap)
            if telemetry is not None and telemetry.run_dir:
                _aggregate.write_sidecar(os.path.join(telemetry.run_dir, "telemetry"), self.pool_name, snap)
        except Exception:
            pass  # telemetry must never break the env's teardown

    def __del__(self):  # pragma: no cover - interpreter teardown
        try:
            if not getattr(self, "_closed", True):
                self.close()
        except Exception:
            pass

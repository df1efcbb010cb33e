"""The player process's start and the context a player loop sees
(counterpart of ``sheeprl_tpu/plane/worker.py``).

A player process is a fresh interpreter (``forkserver`` or ``spawn``, never
``fork``: the learner holds a CUDA context). :func:`child_main` hides the
card before torch is imported anywhere in it (players act on the CPU and
must never open a CUDA context), ignores SIGTERM and SIGINT (the learner
owns the preemption drain; players leave through the stop event), sets the
acting thread count, and imports the algorithm's player loop by dotted name:
nothing is pickled but plain data. This module imports no torch.

:class:`PlayerContext` is the one surface a player loop sees in both modes:
the config and the player's identity, the policy channel, the trajectory
writer (shared-memory slab slots in a process, fresh arrays over a bounded
queue in a thread), the stop event and the protocol's scalars, so that a
loop cannot tell the transports apart (the bitwise thread-against-process
gate).

With the run telemetry on, a player beats the learner's stall watchdog once
an env step and pauses it while it waits for the learner (a policy version,
a slab credit, a commit). A thread player holds the learner's watchdog; a
process player forwards its beats and pauses through the event queue
(:class:`EventWatchdog`: a change of state at once, repeated beats at most
every ``BEAT_INTERVAL_S``), and sends its cumulative counters
(``("telemetry", snapshot)``) after a commit at most every
``SNAPSHOT_INTERVAL_S`` and once at its exit, with its phase histograms,
its env pool's stats and its trace (``telemetry/trace_rank0_player<k>.jsonl``)
written under the run's ``telemetry/`` directory.
"""

from __future__ import annotations

import contextlib
import importlib
import os
import signal
import sys
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

__all__ = ["ACTING_THREADS", "EventWatchdog", "LocalWriter", "PlayerContext", "SlabWriter", "child_main",
           "player_seed", "player_role"]

#: CPU threads for acting, in a player process and in the learner of either mode: a CPU matmul's result can
#: depend on the intra-op thread count, and the 1-player process run must act bitwise as the thread run
ACTING_THREADS = 1
#: a process player's forwarded watchdog beats and its counter snapshots, at most once per this many seconds
BEAT_INTERVAL_S = 0.5
SNAPSHOT_INTERVAL_S = 10.0


def player_role(player_idx: int) -> str:
    """A player's role on the learner's stall watchdog."""
    return f"plane-player-{int(player_idx)}"


class EventWatchdog:
    """A process player's side of the learner's stall watchdog: the
    :class:`~sheeprl_tpu_torch.obs.health.StallWatchdog` calls a player
    makes (``register``, ``beat``, ``pause``, ``unregister``), sent through
    the plane's event queue as ``(idx, "watchdog", state)``. A change of
    state (paused, beating) is sent at once; repeated beats at most every
    ``interval_s``."""

    def __init__(self, events, player_idx: int, interval_s: float = BEAT_INTERVAL_S):
        self._events = events
        self._idx = int(player_idx)
        self.interval_s = float(interval_s)
        self._sent: Optional[str] = None
        self._last = 0.0

    def _send(self, state: str) -> None:
        now = time.monotonic()
        if state == self._sent and (state != "beat" or now - self._last < self.interval_s):
            return
        self._sent, self._last = state, now
        try:
            self._events.put((self._idx, "watchdog", state))
        except Exception:
            pass  # telemetry must never take a player down

    def register(self, role: str) -> None:
        self._send("beat")

    def beat(self, role: str) -> None:
        self._send("beat")

    def pause(self, role: str) -> None:
        self._send("pause")

    def unregister(self, role: str) -> None:
        self._send("unregister")


def player_seed(seed: int, player_idx: int) -> int:
    """The seed of player ``player_idx``'s acting generator: from the run's
    seed and the index only, the same in a thread and in a process."""
    return int(np.random.SeedSequence([int(seed), int(player_idx)]).generate_state(1, np.uint64)[0] >> 1)


class SlabWriter:
    """The process transport's writer: credited shared-memory slab slots."""

    def __init__(self, ring):
        self._ring = ring

    def acquire(self, stop=None) -> Tuple[Any, Dict[str, np.ndarray]]:
        slot = self._ring.acquire(stop)
        return slot, self._ring.writer_views(slot)

    def commit(self, token, views, first_update, n_valid, version, ep_stats, seconds, stop=None) -> None:
        self._ring.commit(token, first_update, n_valid, version, ep_stats, seconds)


class LocalWriter:
    """The thread transport's writer: fresh arrays a burst over a bounded
    queue (the commit blocks while the learner is behind)."""

    def __init__(self, burst_queue, spec):
        self._q = burst_queue
        self._spec = spec

    def acquire(self, stop=None) -> Tuple[Any, Dict[str, np.ndarray]]:
        return None, {key: np.empty(shape, dtype=np.dtype(dtype)) for key, shape, dtype in self._spec.keys}

    def commit(self, token, views, first_update, n_valid, version, ep_stats, seconds, stop=None) -> None:
        from sheeprl_tpu_torch.plane.local import BurstPayload

        self._q.commit(BurstPayload(data=views, first_update=int(first_update), n_valid=int(n_valid),
                                    policy_version=int(version), ep_stats=list(ep_stats or []),
                                    seconds=dict(seconds), commit_ts=time.time()), stop=stop)


class _HaltSignal:
    """``stop`` or orphaned, for a player's blocking waits: a learner that
    died without draining never sets the stop event."""

    __slots__ = ("_ctx",)

    def __init__(self, ctx: "PlayerContext"):
        self._ctx = ctx

    def is_set(self) -> bool:
        return (self._ctx.stop is not None and self._ctx.stop.is_set()) or self._ctx.orphaned()


@dataclass
class PlayerContext:
    """Everything a player loop needs, whatever the transport."""

    cfg: Any
    player_idx: int
    n_envs: int  # this player's envs
    env_rank: int  # the seed partition handed to env_seeds()
    start_update: int
    restart_count: int
    log_dir: Optional[str]
    channel: Any  # wait_min_version(min_version, stop, use_exact)
    writer: Any  # SlabWriter | LocalWriter
    stop: Any  # threading.Event | multiprocessing Event
    seed: int  # the acting generator's seed (player_seed)
    scalars: Dict[str, int] = field(default_factory=dict)
    process_mode: bool = False
    parent_pid: Optional[int] = None
    #: the current burst's host seconds by phase, sent with its slab (``policy_wait`` and ``slab_wait`` here; the
    #: loop adds its own, ``env`` and ``act``, with :meth:`timed`)
    seconds: Dict[str, float] = field(default_factory=dict)
    #: the stall watchdog this player beats (the learner's in a thread, an EventWatchdog in a process), or None
    watchdog: Any = None
    #: a process player's counter-snapshot sender, called after each commit (rate-limited), or None
    telemetry_sink: Any = None
    _wd_registered: bool = field(default=False, init=False, repr=False)

    @contextlib.contextmanager
    def timed(self, phase: str) -> Iterator[None]:
        """Add the block's host seconds to this burst's ``phase``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[phase] = self.seconds.get(phase, 0.0) + time.perf_counter() - t0

    def _watchdog(self):
        wd = self.watchdog
        if wd is not None and not self._wd_registered:
            wd.register(player_role(self.player_idx))
            self._wd_registered = True
        return wd

    def beat(self) -> None:
        """Once per unit of progress (an env step): a hung env wedges the
        player mid-burst, and without a beat the stall stays silent."""
        wd = self._watchdog()
        if wd is not None:
            wd.beat(player_role(self.player_idx))

    def pause_watchdog(self) -> None:
        """Before blocking on the learner: waiting for the peer is idleness, not a stall."""
        wd = self._watchdog()
        if wd is not None:
            wd.pause(player_role(self.player_idx))

    def close_watchdog(self) -> None:
        """A finished player is not a stalled one."""
        if self.watchdog is not None and self._wd_registered:
            self.watchdog.unregister(player_role(self.player_idx))

    def orphaned(self) -> bool:
        """A player whose parent died leaves (players are not daemonic: they
        own env worker pools)."""
        return self.process_mode and self.parent_pid is not None and os.getppid() != self.parent_pid

    @property
    def halt(self) -> _HaltSignal:
        return _HaltSignal(self)

    @property
    def num_updates(self) -> int:
        return int(self.scalars["num_updates"])

    @property
    def learning_starts(self) -> int:
        return int(self.scalars.get("learning_starts", 0))

    @property
    def first_train_update(self) -> int:
        return int(self.scalars["first_train_update"])

    @property
    def act_burst(self) -> int:
        return max(int(self.scalars.get("act_burst", 1)), 1)

    @property
    def max_policy_lag(self) -> int:
        return max(int(self.scalars.get("max_policy_lag", 0)), 0)

    def wait_policy(self, first_update: int) -> Tuple[int, Any]:
        """The version acting at ``first_update`` needs (less the allowed
        lag): exactly that version at lag 0, the newest one otherwise."""
        from sheeprl_tpu_torch.plane.protocol import required_version

        lag = self.max_policy_lag
        req = required_version(first_update, self.first_train_update)
        self.pause_watchdog()
        with self.timed("policy_wait"):
            got = self.channel.wait_min_version(max(req - lag, 0), stop=self.halt, use_exact=(lag == 0))
        self.beat()
        return got

    def acquire_slab(self) -> Tuple[Any, Dict[str, np.ndarray]]:
        """A slab credit and its write views; blocks under backpressure."""
        self.pause_watchdog()
        with self.timed("slab_wait"):
            got = self.writer.acquire(self.halt)
        self.beat()
        return got

    def emit(self, token, views, first_update: int, n_valid: int, version: int,
             ep_stats: List[Tuple[float, float]]) -> None:
        """Commit the burst with its host seconds by phase (then zeroed)."""
        seconds, self.seconds = self.seconds, {}
        self.pause_watchdog()  # a full queue blocks here, at the learner's pace
        self.writer.commit(token, views, first_update, n_valid, version, ep_stats, seconds, stop=self.halt)
        if self.telemetry_sink is not None:
            try:
                self.telemetry_sink()
            except Exception:
                pass  # telemetry must never take a player down
        self.beat()


def _install_player_telemetry(spec: Dict[str, Any], idx: int) -> Tuple[Any, Any, Any]:
    """A process player's own counters, phase histograms and (with the
    learner's trace on) trace writer, pid ``100 + idx`` so that its track
    stays apart from the learner's in a merged view."""
    from sheeprl_tpu_torch.obs import counters as _counters
    from sheeprl_tpu_torch.obs import hist as _hist

    counters, hists, tracer = _counters.Counters(), _hist.HistogramSet(), None
    _counters.install(counters)
    _hist.install(hists)
    if spec.get("trace") and spec.get("log_dir"):
        from sheeprl_tpu_torch.obs.spans import TraceWriter, set_tracer

        try:
            tracer = TraceWriter(os.path.join(spec["log_dir"], "telemetry", f"trace_rank0_player{idx}.jsonl"),
                                 xla_annotations=False, pid=100 + idx, process_name=f"player{idx}")
            set_tracer(tracer)
        except OSError:
            tracer = None
    return counters, hists, tracer


def _snapshot_sink(events, idx: int, counters):
    """The rate-limited sender of a player's cumulative counters."""
    last = [0.0]

    def sink() -> None:
        now = time.monotonic()
        if now - last[0] >= SNAPSHOT_INTERVAL_S:
            last[0] = now
            events.put((idx, "telemetry", counters.as_dict()))

    return sink


def _finish_player_telemetry(spec: Dict[str, Any], idx: int, events, counters, hists, tracer) -> None:
    """At a player's exit: its last snapshot to the learner, its histograms
    (``hist_rank0_player<k>.json``, merged at the learner's finalize) and its
    sidecar (counters, phase percentiles, restarts, env pools)."""
    from sheeprl_tpu_torch.obs.dist import aggregate as _aggregate

    try:
        events.put((idx, "telemetry", counters.as_dict()))
    except Exception:
        pass
    if spec.get("log_dir"):
        tel_dir = os.path.join(spec["log_dir"], "telemetry")
        try:
            _aggregate.atomic_write_json(os.path.join(tel_dir, f"hist_rank0_player{idx}.json"), hists.to_dict())
        except Exception:
            pass
        sidecar = dict(counters.as_dict())
        sidecar["phase_percentiles"] = hists.percentiles()
        sidecar["restart_count"] = int(spec.get("restart_count", 0))
        pools = _aggregate.source_snapshots()
        if pools:
            sidecar["env_pools"] = pools
        _aggregate.write_sidecar(tel_dir, f"player{idx}", sidecar)
    if tracer is not None:
        try:
            tracer.close()
        except Exception:
            pass


def child_main(spec: Dict[str, Any]) -> None:
    """A player process's entry (the supervisor's ``Process`` target)."""
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    # before torch: a player never sees, initialises or holds the card
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    for path in spec.get("sys_path", ()):
        if path not in sys.path:
            sys.path.append(path)
    import torch

    torch.set_num_threads(ACTING_THREADS)

    from sheeprl_tpu_torch.plane.slabs import PlaneClosed
    from sheeprl_tpu_torch.utils import dotdict

    idx = int(spec["player_idx"])
    events = spec["events"]
    telemetry = _install_player_telemetry(spec, idx) if spec.get("telemetry") else None
    ctx = PlayerContext(
        cfg=dotdict(spec["cfg"]),
        player_idx=idx,
        n_envs=int(spec["n_envs"]),
        env_rank=int(spec["env_rank"]),
        start_update=int(spec["start_update"]),
        restart_count=int(spec["restart_count"]),
        log_dir=spec.get("log_dir"),
        channel=spec["channel"],
        writer=SlabWriter(spec["ring"]),
        stop=spec["stop"],
        seed=int(spec["seed"]),
        scalars=dict(spec["scalars"]),
        process_mode=True,
        parent_pid=os.getppid(),
    )
    if telemetry is not None:
        ctx.watchdog = EventWatchdog(events, idx)
        ctx.telemetry_sink = _snapshot_sink(events, idx, telemetry[0])
    module_name, fn_name = str(spec["entry"]).split(":")
    rc = 0
    try:
        getattr(importlib.import_module(module_name), fn_name)(ctx)
    except PlaneClosed:
        pass
    except BaseException:
        rc = 1
        try:
            events.put((idx, "error", traceback.format_exc(limit=20)))
        except Exception:
            pass
    if telemetry is not None:
        _finish_player_telemetry(spec, idx, events, *telemetry)
    try:
        events.put((idx, "exit", {"cuda_initialized": bool(torch.cuda.is_initialized())}))
    except Exception:
        pass
    sys.exit(rc)

"""The learner's side of the actor–learner plane (counterpart of
``sheeprl_tpu/plane/supervisor.py``).

:class:`ProcessPlane` runs N player processes: a
:class:`~sheeprl_tpu_torch.plane.slabs.TrajSlabRing` each, the
:class:`~sheeprl_tpu_torch.plane.publish.SharedPolicyChannel` the players
read every version from (a copy into shared memory), and an event queue
for the players' errors, watchdog beats and counter snapshots. Every
version is also published to ``<log_dir>/policy/`` through an asynchronous
:class:`~sheeprl_tpu_torch.plane.publish.PolicyPublisher`, as the JAX
package publishes it (a gateway with ``serve.poll_root`` follows it): its
writer processes (of the plane's multiprocessing context) take the versions
in order from a bounded queue, so writers slower than the updates block the
learner's ``publish``, timed as the ``Time/policy_publish_time`` span. A
player that dies (crash, kill) is started again from the latest published
version at the burst the learner expects next, on a fresh ring, at most
``plane.max_player_restarts`` times a player; ``plane.recv_timeout_s``
bounds a wait for one burst.
:class:`LocalPlane` is the same surface over one player thread
(``plane.num_players=0``). The decoupled learners are written against that
surface and never branch on the mode.

With the run telemetry on, both planes count the slabs received, the newest
version and the restarts, feed the staleness lineage (each burst's policy
lag, the slab queue's depth, the commit stamp of the rows the learner adds
next), and run the stall watchdog over the learner and every player (a
process player's beats arrive through the event queue). A process player's
counter snapshots are folded into the learner's counters as deltas and
published as the source ``player<k>``.
"""

from __future__ import annotations

import contextlib
import os
import queue as _queue
import sys
import time
import warnings
from typing import Any, Callable, Dict, Iterator, List, Optional

from sheeprl_tpu_torch.obs import counters as _counters
from sheeprl_tpu_torch.obs.dist import aggregate as _aggregate
from sheeprl_tpu_torch.obs.dist import staleness as _staleness
from sheeprl_tpu_torch.obs.spans import span
from sheeprl_tpu_torch.plane.local import LocalBurstQueue, LocalPlayerHandle
from sheeprl_tpu_torch.plane.publish import LocalPolicyChannel, PolicyPublisher, SharedPolicyChannel
from sheeprl_tpu_torch.plane.slabs import SlabSpec, TrajSlabRing
from sheeprl_tpu_torch.plane.worker import ACTING_THREADS, PlayerContext, player_role, player_seed

__all__ = ["POLICY_DIR", "LocalPlane", "ProcessPlane", "build_plane", "plane_env_split", "resolve_plane_players"]

#: the run directory's policy publications (``<log_dir>/policy/policy_<version>``)
POLICY_DIR = "policy"

#: a process player's counters folded into the learner's: the deltas of its cumulative snapshots
_FOLDED_COUNTERS = (
    "env_steps_async",
    "env_worker_restarts",
    "env_degraded_to_sync",
    "act_dispatches",
    "rollout_bursts",
    "env_steps_jax",
)


def _get_telemetry():
    from sheeprl_tpu_torch.obs.telemetry import get_telemetry

    return get_telemetry()


def _observe_burst(plane, policy_version: int, commit_ts: float, depth) -> None:
    """A received burst: the slab count, its policy lag behind the newest
    published version, the slab queue's depth, and the commit stamp the
    learner's next ``rb.add`` carries."""
    _counters.add_plane_slabs()
    published = plane.published_version
    if published is not None and policy_version >= 0:
        _staleness.observe_policy_lag(max(published - int(policy_version), 0))
    _staleness.note_queue_depth("plane_slab_queue", depth)
    if commit_ts:
        _staleness.stamp_next_add(commit_ts)


def resolve_plane_players(cfg) -> int:
    """``plane.num_players`` (0: the thread mode)."""
    try:
        return max(int((cfg.get("plane", {}) or {}).get("num_players", 0) or 0), 0)
    except AttributeError:
        return 0


def plane_env_split(cfg, n_envs: int):
    """``(num_players, envs_per_player)``: each player owns an equal slice
    of the envs (the thread mode's one player all of them)."""
    num_players = resolve_plane_players(cfg)
    if num_players > 0 and n_envs % num_players != 0:
        raise ValueError(f"plane.num_players={num_players} must divide the env fleet "
                         f"(env.num_envs * world_size = {n_envs})")
    return num_players, (n_envs // num_players if num_players > 0 else n_envs)


def _plane_cfg(cfg) -> Dict[str, Any]:
    return dict(cfg.get("plane", {}) or {})


def build_plane(cfg, *, spec: SlabSpec, entry: str, run_player: Callable[[Any], None], scalars: Dict[str, int],
                start_update: int, n_envs: int, log_dir: str, thread_name: str, initial_params: Any):
    """The bring-up both decoupled learners share: the transport from
    ``plane.num_players``, version 0 (the initial or resumed parameters,
    as host arrays) published before a player starts, and the start. The
    learner's process acts with ``ACTING_THREADS`` CPU threads from here
    until the plane is drained, as every player does."""
    import torch

    num_players, envs_per_player = plane_env_split(cfg, n_envs)
    threads = torch.get_num_threads()
    torch.set_num_threads(ACTING_THREADS)
    telemetry = _get_telemetry()
    watchdog = telemetry.watchdog() if telemetry is not None else None
    if num_players > 0:
        plane: Any = ProcessPlane(cfg, log_dir=log_dir, entry=entry, spec=spec, n_players=num_players,
                                  envs_per_player=envs_per_player, scalars=scalars, start_update=start_update)
    else:
        ctx = PlayerContext(cfg=cfg, player_idx=0, n_envs=n_envs, env_rank=0, start_update=start_update,
                            restart_count=0, log_dir=log_dir, channel=None, writer=None, stop=None,
                            seed=player_seed(cfg.seed, 0), scalars=scalars, watchdog=watchdog)
        plane = LocalPlane(cfg, spec, lambda: run_player(ctx), name=thread_name)
        ctx.channel, ctx.writer, ctx.stop = plane.channel, plane.writer, plane.stop
    if watchdog is not None:
        plane.watch(watchdog, thread_name.replace("player", "learner"))
    plane.restore_threads = threads
    plane.publish(0, initial_params)
    return plane.start()


class LocalPlane:
    """One player thread (``plane.num_players=0``)."""

    n_players = 1

    def __init__(self, cfg, spec: SlabSpec, player_fn: Callable[[], Any], *, name: str):
        from sheeprl_tpu_torch.plane.worker import LocalWriter

        pcfg = _plane_cfg(cfg)
        self.channel = LocalPolicyChannel(keep_policies=int(pcfg.get("keep_policies", 4)))
        self._queue = LocalBurstQueue(int(pcfg.get("queue_slots", 4)))
        self.writer = LocalWriter(self._queue, spec)
        self._handle = LocalPlayerHandle(player_fn, name=name)
        self.recv_timeout_s = float(pcfg.get("recv_timeout_s", 300.0) or 0.0)
        self.restore_threads: Optional[int] = None
        #: bursts received, the newest version published, restarts (none in a thread)
        self.slabs = 0
        self.published_version: Optional[int] = None
        self.player_restarts = 0
        self.watchdog: Any = None
        self.learner_role = ""

    @property
    def stop(self):
        return self._handle.stop

    def watch(self, watchdog, learner_role: str) -> None:
        """Run the stall watchdog over the learner's waits (and the player's beats)."""
        _watch(self, watchdog, learner_role)

    def start(self) -> "LocalPlane":
        self._handle.start()
        return self

    def publish(self, version: int, params: Any) -> None:
        with span("Time/policy_publish_time", phase="publish"):
            self.channel.publish(version, params)
        self.published_version = int(version)
        _counters.note_plane_policy_version(version)

    def recv(self, idx: int, expected_first: int):
        """The next burst; raises if the thread died or stayed silent past ``plane.recv_timeout_s``."""
        with _learner_waits(self):
            return self._recv(expected_first)

    def _recv(self, expected_first: int):
        deadline = time.monotonic() + self.recv_timeout_s if self.recv_timeout_s > 0 else None
        while True:
            payload = self._queue.recv(timeout=0.5)
            if payload is not None:
                if payload.first_update != expected_first:
                    raise RuntimeError(f"plane protocol drift: learner expected the burst at update {expected_first}, "
                                       f"player sent {payload.first_update}")
                self.slabs += 1
                _observe_burst(self, payload.policy_version, payload.commit_ts, self._queue.depth())
                return payload
            self._handle.check()
            if not self._handle.alive():
                raise RuntimeError("decoupled player thread exited before the run finished")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"plane: no trajectory burst from the player thread within {self.recv_timeout_s}s "
                                   f"(update {expected_first})")

    def drain(self, timeout: float = 30.0) -> None:
        self._handle.stop.set()
        self._queue.drain()
        self._handle.join(timeout=timeout)
        _unwatch(self)
        _restore_threads(self)


def _watch(plane, watchdog, learner_role: str) -> None:
    plane.watchdog, plane.learner_role = watchdog, learner_role
    watchdog.register(learner_role)
    watchdog.start()


def _unwatch(plane) -> None:
    """A drained plane's roles are done (a finished run is not a stalled one)."""
    if plane.watchdog is not None:
        plane.watchdog.stop()
        plane.watchdog = None


@contextlib.contextmanager
def _learner_waits(plane) -> Iterator[None]:
    """The learner's wait for a burst: its watchdog role paused, then beaten."""
    if plane.watchdog is not None:
        plane.watchdog.pause(plane.learner_role)
    yield
    if plane.watchdog is not None:
        plane.watchdog.beat(plane.learner_role)


def _restore_threads(plane) -> None:
    if plane.restore_threads is not None:
        import torch

        torch.set_num_threads(plane.restore_threads)
        plane.restore_threads = None


class ProcessPlane:
    """N player processes over shared-memory slab rings."""

    def __init__(self, cfg, *, log_dir: str, entry: str, spec: SlabSpec, n_players: int, envs_per_player: int,
                 scalars: Dict[str, int], start_update: int):
        import multiprocessing as mp

        pcfg = _plane_cfg(cfg)
        self.cfg = cfg
        self.log_dir = log_dir
        self.entry = entry
        self.spec = spec
        self.n_players = int(n_players)
        self.envs_per_player = int(envs_per_player)
        self.scalars = dict(scalars)
        self.queue_slots = max(int(pcfg.get("queue_slots", 4)), 1)
        self.max_restarts = max(int(pcfg.get("max_player_restarts", 2)), 0)
        self.keep_policies = int(pcfg.get("keep_policies", 4))
        self.recv_timeout_s = float(pcfg.get("recv_timeout_s", 300.0) or 0.0)
        method = str(cfg.env.get("mp_context", "forkserver") or "forkserver")
        if method == "fork":
            raise ValueError("env.mp_context=fork: plane players start with forkserver or spawn, never fork "
                             "(the learner process holds a CUDA context)")
        self._mp = mp.get_context(method)
        self.stop = self._mp.Event()
        self._events = self._mp.Queue()
        #: made at the first publication (its arrays fix the layout), before any player starts
        self.channel: Optional[SharedPolicyChannel] = None
        #: every version to <log_dir>/policy/ by writer processes (a bounded FIFO: every version lands, in order)
        self.publisher = PolicyPublisher(os.path.join(log_dir, POLICY_DIR), keep_policies=self.keep_policies,
                                         algo=str(cfg.algo.name), async_publish=True, mp_context=self._mp)
        telemetry = _get_telemetry()
        self._telemetry = telemetry is not None
        self._trace = bool(telemetry is not None and telemetry.trace_enabled)
        self.watchdog: Any = None
        self.learner_role = ""
        #: the watchdog beats each player forwarded (they stay counted after the player unregisters at its exit)
        self.watchdog_beats: Dict[int, int] = {}
        #: each player's last cumulative counter snapshot: the fold adds the deltas
        self._last_snaps: Dict[int, Dict[str, Any]] = {}
        self._rings: List[Optional[TrajSlabRing]] = [None] * self.n_players
        self._procs: List[Optional[Any]] = [None] * self.n_players
        self._restarts = [0] * self.n_players
        self._errors: Dict[int, str] = {}
        self._start_update = int(start_update)
        self._cfg_plain = _plain(cfg)
        self.restore_threads: Optional[int] = None
        self.slabs = 0
        self.published_version: Optional[int] = None
        #: each player's report at its exit (whether CUDA was initialised in it)
        self.exits: Dict[int, Dict[str, Any]] = {}

    @property
    def player_restarts(self) -> int:
        return sum(self._restarts)

    def watch(self, watchdog, learner_role: str) -> None:
        """Run the stall watchdog over the learner's waits and the players' forwarded beats."""
        _watch(self, watchdog, learner_role)

    def pids(self) -> List[int]:
        """The live player processes' pids."""
        return [p.pid for p in self._procs if p is not None and p.is_alive()]

    def start(self) -> "ProcessPlane":
        for idx in range(self.n_players):
            self._spawn(idx, self._start_update)
        return self

    def _spawn(self, idx: int, start_update: int) -> None:
        from sheeprl_tpu_torch.plane.worker import child_main

        ring = TrajSlabRing(self._mp, self.spec, self.queue_slots)
        spec = {
            "entry": self.entry, "cfg": self._cfg_plain, "player_idx": idx, "n_envs": self.envs_per_player, "env_rank": idx, "start_update": int(start_update),
            "restart_count": self._restarts[idx], "log_dir": self.log_dir, "channel": self.channel, "ring": ring, "stop": self.stop, "events": self._events,
            "seed": player_seed(self.cfg.seed, idx), "scalars": self.scalars, "sys_path": list(sys.path),
            "telemetry": self._telemetry, "trace": self._trace,
        }
        # not daemonic: a player owns an env worker pool; the orphan watch and drain's ladder cover it
        proc = self._mp.Process(target=child_main, args=(spec,), name=f"plane-player-{idx}", daemon=False)
        proc.start()
        old, self._rings[idx], self._procs[idx] = self._rings[idx], ring, proc
        if old is not None:
            old.close()

    def publish(self, version: int, params: Any) -> None:
        """The version to the players' shared channel, then to the policy
        directory's writer queue (blocks while 8 versions wait for the disk)."""
        with span("Time/policy_publish_time", phase="publish"):
            if self.channel is None:
                self.channel = SharedPolicyChannel(self._mp, params, self.keep_policies)
            self.channel.publish(version, params)
            self.publisher.publish(version, params)
        self.published_version = int(version)
        _counters.note_plane_policy_version(version)

    def recv(self, idx: int, expected_first: int):
        """Player ``idx``'s burst starting at ``expected_first``, the player
        started again (fresh ring, latest version) if it died."""
        with _learner_waits(self):
            return self._recv(idx, expected_first)

    def _recv(self, idx: int, expected_first: int):
        deadline = time.monotonic() + self.recv_timeout_s if self.recv_timeout_s > 0 else None
        while True:
            handle = self._rings[idx].recv(timeout=0.5)
            self._drain_events()
            if handle is not None:
                if handle.first_update != expected_first:
                    handle.release()
                    raise RuntimeError(f"plane protocol drift: learner expected the burst at update {expected_first} "
                                       f"from player {idx}, got {handle.first_update}")
                self.slabs += 1
                _observe_burst(self, handle.policy_version, handle.commit_ts, self._rings[idx].depth())
                return handle
            proc = self._procs[idx]
            if proc is not None and not proc.is_alive():
                self._respawn(idx, expected_first)
                if deadline is not None:
                    # the replacement pays its start, its env pool and a whole burst
                    deadline = time.monotonic() + self.recv_timeout_s
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"plane: no trajectory burst from player {idx} within {self.recv_timeout_s}s "
                                   f"(update {expected_first})")

    def _respawn(self, idx: int, next_update: int) -> None:
        err = self._errors.pop(idx, None)
        self._restarts[idx] += 1
        if self._restarts[idx] > self.max_restarts:
            raise RuntimeError(f"plane player {idx} died and exhausted its restart budget ({self.max_restarts})"
                               + (f"; last error:\n{err}" if err else ""))
        warnings.warn(f"plane player {idx} died (restart {self._restarts[idx]}/{self.max_restarts}); respawning at "
                      f"update {next_update} from the latest published policy" + (f"; error:\n{err}" if err else ""))
        _counters.add_plane_player_restart()
        # the replacement's counters start at zero: so does its delta fold
        self._last_snaps.pop(idx, None)
        telemetry = _get_telemetry()
        if telemetry is not None and telemetry.flight is not None:
            telemetry.flight.trigger("plane_player_restart",
                                     {"player": idx, "restart": self._restarts[idx], "update": next_update})
        self._spawn(idx, next_update)

    def _drain_events(self) -> None:
        while True:
            try:
                idx, kind, payload = self._events.get_nowait()
            except _queue.Empty:
                return
            if kind == "error":
                self._errors[int(idx)] = str(payload)
            elif kind == "exit":
                self.exits[int(idx)] = dict(payload)
            elif kind == "telemetry":
                self._fold_counters(int(idx), payload)
            elif kind == "watchdog" and self.watchdog is not None:
                if payload == "beat":
                    self.watchdog_beats[int(idx)] = self.watchdog_beats.get(int(idx), 0) + 1
                role = player_role(int(idx))
                {"beat": self.watchdog.beat, "pause": self.watchdog.pause,
                 "unregister": self.watchdog.unregister}[payload](role)

    def _fold_counters(self, idx: int, snap: Dict[str, Any]) -> None:
        """One player's cumulative counter snapshot: the learner's counters
        advance by the delta since that player's previous snapshot, and the
        snapshot is published as the source ``player<idx>``."""
        if not isinstance(snap, dict):
            return
        _aggregate.publish_source(f"player{idx}", snap)
        counters = _counters.installed()
        if counters is None:
            return
        last = self._last_snaps.get(idx, {})
        for name in _FOLDED_COUNTERS:
            delta = int(snap.get(name, 0) or 0) - int(last.get(name, 0) or 0)
            if delta > 0:
                counters.add(name, delta)
        self._last_snaps[idx] = snap

    def drain(self, timeout: float = 30.0) -> None:
        """Stop the players and join them (also the preemption path: the
        learner's checkpoint breaks its loop, then the players, which ignore
        the signal, leave through the stop event)."""
        self.stop.set()
        deadline = time.monotonic() + timeout
        for idx, proc in enumerate(self._procs):
            if proc is None:
                continue
            ring = self._rings[idx]
            while ring is not None:  # free a player blocked on a full slab queue
                h = ring.recv(timeout=0.01)
                if h is None:
                    break
                h.release()
            proc.join(timeout=max(deadline - time.monotonic(), 0.5))
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=5.0)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=5.0)
        self._drain_events()
        for ring in self._rings:
            if ring is not None:
                ring.close()
        try:
            self._events.cancel_join_thread()
            self._events.close()
        except Exception:
            pass
        self.publisher.close()
        _unwatch(self)
        _restore_threads(self)


def _plain(cfg) -> Any:
    """A picklable deep copy of the config."""
    from sheeprl_tpu_torch.utils import dotdict

    def rec(node):
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [rec(v) for v in node]
        return node

    return dotdict(rec(cfg))

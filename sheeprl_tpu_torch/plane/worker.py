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
"""

from __future__ import annotations

import importlib
import os
import signal
import sys
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["ACTING_THREADS", "LocalWriter", "PlayerContext", "SlabWriter", "child_main", "player_seed"]

#: CPU threads for acting, in a player process and in the learner of either mode: a CPU matmul's result can
#: depend on the intra-op thread count, and the 1-player process run must act bitwise as the thread run
ACTING_THREADS = 1


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
                                    seconds=dict(seconds)), stop=stop)


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
    #: loop adds its own, ``env`` and ``act``, with :meth:`add_seconds`)
    seconds: Dict[str, float] = field(default_factory=dict)

    def add_seconds(self, phase: str, since: float) -> None:
        """Add the time since ``since`` (a ``perf_counter`` reading) to this burst's ``phase``."""
        self.seconds[phase] = self.seconds.get(phase, 0.0) + time.perf_counter() - since

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
        t0 = time.perf_counter()
        got = self.channel.wait_min_version(max(req - lag, 0), stop=self.halt, use_exact=(lag == 0))
        self.add_seconds("policy_wait", t0)
        return got

    def acquire_slab(self) -> Tuple[Any, Dict[str, np.ndarray]]:
        """A slab credit and its write views; blocks under backpressure."""
        t0 = time.perf_counter()
        got = self.writer.acquire(self.halt)
        self.add_seconds("slab_wait", t0)
        return got

    def emit(self, token, views, first_update: int, n_valid: int, version: int,
             ep_stats: List[Tuple[float, float]]) -> None:
        """Commit the burst with its host seconds by phase (then zeroed)."""
        seconds, self.seconds = self.seconds, {}
        self.writer.commit(token, views, first_update, n_valid, version, ep_stats, seconds, stop=self.halt)


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
    try:
        events.put((idx, "exit", {"cuda_initialized": bool(torch.cuda.is_initialized())}))
    except Exception:
        pass
    sys.exit(rc)

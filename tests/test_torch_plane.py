"""The port's actor–learner plane (``sheeprl_tpu_torch/plane``) against the
JAX package's, on the CPU.

- the protocol's arithmetic (``burst_plan``, ``train_gated_burst_plan``,
  ``version_after``, ``required_version``) equals JAX's over a grid, exactly;
- slab layouts, credits, backpressure and ``PlaneClosed``: the slab ring,
  the thread transport's queue and the in-process policy channel;
- the player's context waits for the protocol's version;
- faults on the process plane through the CLI (``exp=sac_decoupled``): a
  SIGKILLed player is started again from the latest version and the run
  finishes; a SIGTERM checkpoints, drains the players, and the run resumes
  with players live.

No JAX ``Fabric`` is built here, so JAX's key implementation is left alone.
"""

from __future__ import annotations

import itertools
import multiprocessing as mp
import os
import signal
import threading
import time

import numpy as np
import pytest

from sheeprl_tpu_torch.plane import (
    LocalBurstQueue,
    LocalPolicyChannel,
    PlaneClosed,
    PlayerContext,
    SlabSpec,
    TrajSlabRing,
    burst_plan,
    plane_env_split,
    required_version,
    version_after,
)
from sheeprl_tpu_torch.plane.local import BurstPayload


def _spec(steps=4, n_envs=2, obs=3):
    return SlabSpec.from_arrays({"observations": np.zeros((steps, n_envs, obs), np.float32),
                                 "rewards": np.zeros((steps, n_envs, 1), np.float32)})


# -- the protocol ---------------------------------------------------------------


@pytest.mark.parametrize("fn", ["burst_plan", "train_gated_burst_plan", "version_after", "required_version"])
def test_the_protocol_equals_jax_over_a_grid(fn):
    from sheeprl_tpu.plane import protocol as jax_protocol
    from sheeprl_tpu_torch.plane import protocol

    grids = {
        "burst_plan": itertools.product(range(1, 14), (1, 2, 3, 8), (0, 1, 5, 12), (1, 5, 12, 13)),
        "train_gated_burst_plan": itertools.product(range(1, 14), (1, 3, 8), (0, 5, 12), (5, 13), (1, 4),
                                                    (False, True)),
        "version_after": itertools.product(range(-3, 20), range(0, 12)),
        "required_version": itertools.product(range(-3, 20), range(0, 12)),
    }
    n = 0
    for args in grids[fn]:
        assert getattr(protocol, fn)(*args) == getattr(jax_protocol, fn)(*args), (fn, args)
        n += 1
    assert n > 100


def test_a_player_never_waits_for_a_version_no_update_will_publish():
    for act_burst, (first_train, learning_starts) in itertools.product((1, 3, 8), ((5, 5), (1, 0), (7, 3))):
        published, update, num_updates = 0, 1, 50
        while update <= num_updates:
            n_act, random_phase = burst_plan(update, act_burst, learning_starts, num_updates)
            if not random_phase:
                assert required_version(update, first_train) <= published
            last = update + n_act - 1
            if last >= learning_starts:
                published = max(published, version_after(last, first_train))
            update = last + 1


def test_slab_specs_are_jax_s():
    from sheeprl_tpu.plane import SlabSpec as JaxSlabSpec

    example = {"observations": np.zeros((4, 2, 3), np.float32), "rewards": np.zeros((4, 2, 1), np.float32),
               "rgb": np.zeros((2, 2, 3, 8, 8), np.uint8)}
    spec, want = SlabSpec.from_arrays(example), JaxSlabSpec.from_arrays(example)
    assert spec.keys == want.keys and spec.nbytes() == want.nbytes() == 4 * 2 * 4 * 4 + 2 * 2 * 192


def test_the_env_split_is_jax_s():
    from sheeprl_tpu.plane import plane_env_split as jax_split
    from sheeprl_tpu_torch.config import compose

    for players, n_envs in ((0, 4), (1, 4), (2, 4), (4, 8)):
        cfg = compose(overrides=["exp=sac_decoupled", f"plane.num_players={players}"])
        assert plane_env_split(cfg, n_envs) == jax_split(cfg, n_envs)
    with pytest.raises(ValueError, match="must divide"):
        plane_env_split(compose(overrides=["exp=sac_decoupled", "plane.num_players=3"]), 4)


# -- the slab ring --------------------------------------------------------------


def test_commit_recv_roundtrip_is_zero_copy():
    ring = TrajSlabRing(mp.get_context("spawn"), _spec(), n_slots=2)
    slot = ring.acquire()
    views = ring.writer_views(slot)
    views["observations"][:] = np.arange(24, dtype=np.float32).reshape(4, 2, 3)
    views["rewards"][:] = 1.0
    ring.commit(slot, first_update=7, n_valid=3, policy_version=2, ep_stats=[(1.0, 9.0)], seconds={"env": 0.25})
    handle = ring.recv(timeout=5)
    assert (handle.first_update, handle.n_valid, handle.policy_version, handle.seconds) == (7, 3, 2, {"env": 0.25})
    assert handle.ep_stats == [(1.0, 9.0)]
    assert np.shares_memory(handle.data["observations"], views["observations"])
    np.testing.assert_array_equal(handle.data["observations"][:3],
                                  np.arange(24, dtype=np.float32).reshape(4, 2, 3)[:3])
    handle.release()
    handle.release()  # a second release returns no second credit
    assert ring.acquire() in (0, 1) and ring.acquire() in (0, 1)
    ring.close()


def test_credited_slots_backpressure_the_player_until_a_release():
    ring = TrajSlabRing(mp.get_context("spawn"), _spec(), n_slots=1)
    slot = ring.acquire()
    ring.commit(slot, 1, 4, 0)
    got = {}
    t = threading.Thread(target=lambda: got.setdefault("slot", ring.acquire()), daemon=True)
    t.start()
    t.join(timeout=0.6)
    assert t.is_alive(), "acquire must block while the learner holds every credit"
    ring.recv(timeout=5).release()
    t.join(timeout=5)
    assert not t.is_alive() and got["slot"] == slot
    ring.close()


def test_a_blocked_wait_raises_plane_closed_on_stop():
    ring = TrajSlabRing(mp.get_context("spawn"), _spec(), n_slots=1)
    ring.acquire()
    stop = threading.Event()
    stop.set()
    with pytest.raises(PlaneClosed):
        ring.acquire(stop, poll_s=0.05)
    t0 = time.monotonic()
    assert ring.recv(timeout=0.05) is None and time.monotonic() - t0 < 2.0
    ring.close()
    with pytest.raises(ValueError):
        TrajSlabRing(mp.get_context("spawn"), _spec(), n_slots=0)
    from sheeprl_tpu_torch.plane import publish

    assert publish.PlaneClosed is PlaneClosed  # one class for the rings and the channels


def test_the_local_queue_backpressures_and_closes():
    q = LocalBurstQueue(1)
    q.commit(BurstPayload({}, 1, 1, 0))
    stop = threading.Event()
    t = threading.Thread(target=lambda: q.commit(BurstPayload({}, 2, 1, 0), stop=stop, poll_s=0.05), daemon=True)
    t.start()
    t.join(timeout=0.5)
    assert t.is_alive()
    assert q.recv(timeout=1).first_update == 1
    t.join(timeout=5)
    assert not t.is_alive() and q.recv(timeout=1).first_update == 2
    q.commit(BurstPayload({}, 3, 1, 0))
    stop.set()
    with pytest.raises(PlaneClosed):
        q.commit(BurstPayload({}, 4, 1, 0), stop=stop, poll_s=0.05)


@pytest.mark.parametrize("kind", ["local", "shared"])
def test_the_policy_channels_are_jax_s(kind):
    """The thread transport's channel and the process plane's shared-memory
    one against the JAX package's in-process channel: monotone versions,
    the smallest or the newest held version at least the bound, the oldest
    dropped past ``keep_policies``."""
    from sheeprl_tpu.plane import LocalPolicyChannel as JaxChannel
    from sheeprl_tpu_torch.plane.publish import SharedPolicyChannel

    port = (LocalPolicyChannel(keep_policies=2) if kind == "local"
            else SharedPolicyChannel(mp.get_context("spawn"), {"w": np.zeros(2, np.int64)}, keep_policies=2))
    channels = port, JaxChannel(keep_policies=2)
    for ch in channels:
        for v in (0, 1, 3):
            ch.publish(v, {"w": np.full(2, v)})
        with pytest.raises(ValueError, match="monotone"):
            ch.publish(3, {})
    for min_version, exact in ((0, True), (2, True), (0, False)):
        got = [ch.wait_min_version(min_version, use_exact=exact) for ch in channels]
        assert got[0][0] == got[1][0]
        np.testing.assert_array_equal(got[0][1]["w"], got[1][1]["w"])
    stop = threading.Event()
    stop.set()
    with pytest.raises(PlaneClosed):
        channels[0].wait_min_version(9, stop=stop)


def test_the_player_context_waits_for_the_protocols_version():
    channel = LocalPolicyChannel()
    ctx = PlayerContext(cfg=None, player_idx=0, n_envs=2, env_rank=0, start_update=1, restart_count=0,
                        log_dir=None, channel=channel, writer=None, stop=threading.Event(), seed=0,
                        scalars={"num_updates": 20, "learning_starts": 5, "first_train_update": 5})
    for v in range(4):
        channel.publish(v, {"v": v})
    assert ctx.wait_policy(6) == (0, {"v": 0})  # trained through update 4: nothing yet
    assert ctx.wait_policy(8) == (2, {"v": 2})  # trained through update 6
    ctx.scalars["max_policy_lag"] = 1
    assert ctx.wait_policy(8)[0] == 3  # the newest at least version 1
    assert not ctx.orphaned() and not ctx.halt.is_set()


# -- faults on the process plane --------------------------------------------------


def _sac_args(tmp_path, name, players, total_steps, learning_starts):
    return ["exp=sac_decoupled", "fabric.devices=auto", "fabric.accelerator=cpu", f"plane.num_players={players}",
            "env.id=Pendulum-v1", "env.num_envs=2", "env.capture_video=False",
            "env.vectorization=async", "buffer.memmap=False", "buffer.size=1024", "buffer.prefetch=False",
            "per_rank_batch_size=8", f"total_steps={total_steps}", f"algo.learning_starts={learning_starts}",
            "algo.hidden_size=8", "algo.run_test=False", "metric.log_level=0", "checkpoint.every=1000000",
            "checkpoint.save_last=True", f"root_dir={tmp_path}/{name}", "run_name=test"]


def _final_update(run_root) -> int:
    from sheeprl_tpu_torch.ckpt import read_checkpoint, resolve_latest

    latest = resolve_latest(str(run_root))
    assert latest is not None, f"no resumable checkpoint under {run_root}"
    return int(np.asarray(read_checkpoint(latest, with_rb=False)["update"]))


def test_a_killed_player_is_started_again_and_the_run_finishes(tmp_path, monkeypatch):
    from sheeprl_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    killed = {}

    def kill_one():
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            players = [p for p in mp.active_children() if p.name.startswith("plane-player")]
            if players:
                time.sleep(4.0)  # past its start, a few slabs in
                players = [p for p in mp.active_children() if p.name.startswith("plane-player")]
                if players:
                    os.kill(players[0].pid, signal.SIGKILL)
                    killed["pid"] = players[0].pid
                return
            time.sleep(0.05)

    watcher = threading.Thread(target=kill_one, daemon=True)
    watcher.start()
    with pytest.warns(UserWarning, match="respawning at update"):
        result = cli.run(_sac_args(tmp_path, "faults", 2, total_steps=1200, learning_starts=64))
    watcher.join(timeout=10)
    assert killed.get("pid")
    assert result["plane"]["player_restarts"] == 1 and result["updates"] == 600
    assert _final_update(f"{tmp_path}/faults") == 600


def test_sigterm_drains_the_players_and_the_run_resumes_with_players_live(tmp_path, monkeypatch):
    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.ckpt.preemption import reset_preemption

    monkeypatch.chdir(tmp_path)
    timer = threading.Timer(9.0, os.kill, (os.getpid(), signal.SIGTERM))
    timer.start()
    try:
        cli.run(_sac_args(tmp_path, "preempt", 2, total_steps=200000, learning_starts=64))
    finally:
        timer.cancel()
        reset_preemption()
    saved = _final_update(f"{tmp_path}/preempt")
    assert 0 < saved < 100000, "the run was not cut short"
    assert not [p for p in mp.active_children() if p.name.startswith("plane-player")], "the drain left players"
    total = saved * 2 + 64  # a handful of updates past the cut
    result = cli.run(_sac_args(tmp_path, "preempt", 2, total_steps=total, learning_starts=64)
                     + ["checkpoint.resume_from=latest"])
    # a resumed run repeats its checkpoint's update, as the JAX loop does (start_step = update // world_size)
    assert result["plane"]["players"] == 2 and result["updates"] == total // 2 - saved + 1
    assert _final_update(f"{tmp_path}/preempt") == total // 2

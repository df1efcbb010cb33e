"""The port's run telemetry (``sheeprl_tpu_torch/obs``) against the JAX
package's (``sheeprl_tpu/obs``), module by module, on the same inputs:

- the streaming histograms: the same observations give the same buckets and
  percentiles, and each package's dump merges exactly into the other's;
- ``prometheus_text`` of the same snapshot is byte-equal;
- ``merge_into_summary`` over the same sidecar files gives the same summary;
- the staleness summary of the same ages, lags and queue depths is equal;
- ``Counters().as_dict()`` has the JAX keys plus ``graph_replays``;
- the stall watchdog flags the same stalls for the same scripted beats
  (backpressure pauses, unregister, the cold-start grace), and the
  non-finite guard fires on the same values.

Equality is exact: both sides compute in float64 Python arithmetic.
"""

from __future__ import annotations

import json
import time
import warnings

import numpy as np
import pytest

from sheeprl_tpu.obs import counters as jax_counters
from sheeprl_tpu.obs import health as jax_health
from sheeprl_tpu.obs import hist as jax_hist
from sheeprl_tpu.obs import live as jax_live
from sheeprl_tpu.obs.dist import aggregate as jax_aggregate
from sheeprl_tpu.obs.dist import staleness as jax_staleness
from sheeprl_tpu_torch.obs import counters, health, hist, live
from sheeprl_tpu_torch.obs.dist import aggregate, staleness


def _observations(seed: int, n: int = 2000) -> np.ndarray:
    rng = np.random.default_rng(seed)
    values = np.exp(rng.normal(-5.0, 2.0, size=n))  # seconds over six decades
    values[rng.integers(0, n, size=n // 50)] = 0.0  # clocks that did not advance
    return values


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histograms_bucket_and_merge_as_the_jax_package(seed):
    values = _observations(seed)
    ours, theirs = hist.StreamingHist(), jax_hist.StreamingHist()
    for v in values[:1000]:
        ours.record(v)
        theirs.record(v)
    ours.record_many(values[1000:])
    theirs.record_many(values[1000:])
    assert ours.to_dict() == theirs.to_dict()
    assert ours.percentiles() == theirs.percentiles()
    for q in (0.0, 0.01, 0.5, 0.95, 0.99, 1.0):
        assert ours.quantile(q) == theirs.quantile(q)

    # a split of the observations merged back, across the packages, is the whole
    whole = hist.HistogramSet()
    for v in values:
        whole.observe("Time/train_time", float(v))
    port_half, jax_half = hist.HistogramSet(), jax_hist.HistogramSet()
    for v in values[::2]:
        port_half.observe("Time/train_time", float(v))
    for v in values[1::2]:
        jax_half.observe("Time/train_time", float(v))
    into_port = hist.HistogramSet.merge_all([port_half.to_dict(), jax_half.to_dict()])
    into_jax = jax_hist.HistogramSet.merge_all([json.loads(json.dumps(port_half.to_dict())), jax_half.to_dict()])
    want = whole.to_dict()["Time/train_time"]
    for merged in (into_port.to_dict()["Time/train_time"], into_jax.to_dict()["Time/train_time"]):
        assert merged["buckets"] == want["buckets"] and (merged["n"], merged["zero"]) == (want["n"], want["zero"])
        assert merged["max"] == want["max"] and merged["sum"] == pytest.approx(want["sum"], rel=1e-12)
    assert into_port.percentiles()["Time/train_time"]["p99_ms"] == whole.percentiles()["Time/train_time"]["p99_ms"]


def test_a_histogram_dump_of_another_bucket_base_raises_in_both():
    bad = {"buckets": {"3": 1}, "n": 1, "buckets_per_octave": 4}
    for module in (hist, jax_hist):
        with pytest.raises(ValueError, match="not mergeable"):
            module.StreamingHist.from_dict(bad)


def _snapshot() -> dict:
    """A live snapshot with every section the exposition renders."""
    return {
        "run_wall_s": 12.5,
        "policy_steps": 4096,
        "train_steps": 8,
        "sps": 327.68,
        "mfu": 0.125,
        "recompiles": 2,
        "graph_replays": 6,
        "crashed": False,
        "trace_file": "/x/trace.jsonl",
        "phase_percentiles": {
            "Time/train_time": {"count": 8, "p50_ms": 12.5, "p95_ms": 20.0, "p99_ms": 21.0, "mean_ms": 13.0},
            "Time/env_interaction_time": {"count": 4096, "p50_ms": 0.25, "p95_ms": 0.5, "p99_ms": None},
        },
        "rolling": {"window_s": 30.0, "sps": 300.5, "sps_train": 1.5, "bytes_staged_h2d_per_s": 1e6},
        "watchdog_beat_age_s": {"sac-learner": {"age_s": 0.5, "paused": True, "beats": 9},
                                "plane-player-0": {"age_s": 1.5, "paused": False, "beats": 7}},
        "comms": {"all_reduce": {"ops": 3, "bytes": 4096, "ms": 1.25, "last_gbps": 2.5}},
        "staleness": {
            "sample_age_s": {"count": 10, "p50_s": 0.5, "p95_s": 2.0, "p99_s": 3.0, "max_s": 3.5},
            "policy_lag_versions": {"count": 4, "p50_v": 0.0, "p95_v": 1.0, "p99_v": 1.0, "max_v": 1.0},
            "queue_depth": {"plane_slab_queue": {"last": 1, "max": 3, "samples": 4}},
        },
        "replay_shard_fill": {"0": 0.25, "1": 0.5},
        "sources": {"player0": {"env_steps_async": 64, "act_dispatches": 32, "note": "x"},
                    "player1/envpool_7": {"num_envs": 2, "worker_restarts": 1}},
        "learn": {"bursts_observed": 3, "probes": {"learn/grad_norm": {"n": 3, "last": 1.5, "p50": 1.0}}},
        "serve_versions": {"3": {"requests": 10, "p50_ms": 1.0, "p95_ms": 2.0, "p99_ms": 3.0}},
        "slo": {"alerts_fired": 1, "objectives": {"p99": {"burn_fast": 2.0, "burn_slow": 0.5, "fast_active": True,
                                                          "slow_active": False, "verdict": "PASS"}}},
    }


def test_prometheus_text_is_byte_equal_to_the_jax_package():
    snap = _snapshot()
    text = live.prometheus_text(snap)
    assert text == jax_live.prometheus_text(snap)
    assert text == live.prometheus_text(json.loads(json.dumps(snap)))
    assert 'sheeprl_phase_duration_ms{phase="Time/train_time",quantile="0.99"} 21' in text
    assert 'sheeprl_env_steps_async{source="player0"} 64' in text


def _write_sidecars(tel_dir) -> None:
    tel_dir.mkdir(parents=True, exist_ok=True)
    rank_tracker = jax_staleness.StalenessTracker()
    rank_tracker.observe_sample_ages(np.array([0.5, 1.5, 4.0]))
    rank_tracker.note_queue_depth("plane_slab_queue", 5)
    docs = {
        "player0": {"env_steps_async": 128, "act_dispatches": 64, "phase_percentiles": {},
                    "env_pools": {"envpool_11": {"num_envs": 2, "worker_restarts": 0}}},
        "rank1": {"bytes_staged_h2d": 100, "recompiles": 3, "ckpt_saves": 1, "comms_ms": 2.5,
                  "staleness_dump": rank_tracker.to_dict()},
        "evalproc": {"points": [[10, 1.0]]},
    }
    for name, doc in docs.items():
        (tel_dir / f"sidecar_{name}.json").write_text(json.dumps(doc))
    (tel_dir / "sidecar_torn.json").write_text("{not json")


def test_merge_into_summary_equals_the_jax_package(tmp_path):
    tel_dir = tmp_path / "telemetry"
    _write_sidecars(tel_dir)
    base = {"bytes_staged_h2d": 7, "recompiles": 1, "ckpt_saves": 2, "comms_ms": 0.5, "stalls": 0}
    results = []
    for agg, stale in ((aggregate, staleness), (jax_aggregate, jax_staleness)):
        agg.clear_sources()
        agg.publish_source("player1", {"env_steps_async": 8})
        tracker = stale.StalenessTracker()
        tracker.observe_sample_ages(np.array([0.25, 0.75]))
        summary = agg.merge_into_summary(dict(base), str(tel_dir), tracker)
        summary["staleness"] = tracker.summary()
        results.append(json.loads(json.dumps(summary, sort_keys=True)))
        agg.clear_sources()
    ours, theirs = results
    assert ours == theirs
    assert ours["recompiles"] == 4 and ours["bytes_staged_h2d"] == 107 and ours["comms_ms"] == 3.0
    assert ours["sources"]["torn"] == {"torn": True}
    assert "player0/envpool_11" in ours["sources"] and ours["staleness"]["sample_age_s"]["count"] == 5


def test_the_staleness_summary_equals_the_jax_package():
    rng = np.random.default_rng(3)
    ages = np.exp(rng.normal(0.0, 1.5, size=500))
    lags = rng.integers(0, 4, size=60)
    depths = rng.integers(0, 5, size=40)
    trackers = (staleness.StalenessTracker(), jax_staleness.StalenessTracker())
    for t in trackers:
        assert t.summary() is None
        t.observe_sample_ages(ages[:250])
        t.observe_sample_ages(ages[250:])
        for lag in lags:
            t.observe_policy_lag(int(lag))
        t.observe_policy_lag(2, n=3)
        for d in depths:
            t.note_queue_depth("plane_slab_queue", int(d))
        t.note_queue_depth("staging_prefetch", 1)
    ours, theirs = (t.summary() for t in trackers)
    assert ours == theirs
    # each package's dump merges into the other's
    cross = staleness.StalenessTracker()
    cross.merge_dict(trackers[1].to_dict())
    jax_cross = jax_staleness.StalenessTracker()
    jax_cross.merge_dict(trackers[0].to_dict())
    assert cross.summary()["sample_age_s"] == jax_cross.summary()["sample_age_s"] == ours["sample_age_s"]


def test_the_counters_have_the_jax_keys_and_graph_replays():
    ours, theirs = counters.Counters().as_dict(), jax_counters.Counters().as_dict()
    assert set(ours) == set(theirs) | {"graph_replays"}
    assert {k: v for k, v in ours.items() if k != "graph_replays"} == theirs
    # the producers count as the JAX helpers do, the graph accounting in the JAX keys
    for module in (counters, jax_counters):
        c = module.Counters()
        module.install(c)
        try:
            module.add_h2d_bytes(100)
            module.add_prefetch(hit=True, wait_ms=1.5)
            module.add_prefetch(hit=False)
            module.add_rollout_burst(act_dispatches=2, jax_steps=8)
            module.add_train_burst(steps=4, dispatches=4)
            module.add_plane_slabs(3)
            module.note_plane_policy_version(5)
            module.note_plane_policy_version(2)
            module.add_ckpt_write(12.5, 1000)
            module.add_ckpt_write(1.0, 0, failed=True)
            module.set_replay_shard_fill({0: 0.5})
        finally:
            module.install(None)
        d = c.as_dict()
        assert (d["bytes_staged_h2d"], d["prefetch_hits"], d["prefetch_misses"], d["prefetch_wait_ms"]) == (100, 1, 1, 1.5)
        assert (d["rollout_bursts"], d["act_dispatches"], d["env_steps_jax"], d["train_burst_steps"]) == (1, 2, 8, 4)
        assert (d["plane_traj_slabs"], d["plane_policy_version"], d["ckpt_saves"], d["ckpt_failures"]) == (3, 5, 1, 1)
        assert d["replay_shard_fill"] == {"0": 0.5}
    c = counters.Counters()
    counters.install(c)
    fired = []
    counters.set_compile_hook(fired.append)
    try:
        counters.add_graph_capture(0.25)
        counters.add_graph_replays(5)
        counters.add_compile_cache_hit()
    finally:
        counters.set_compile_hook(None)
        counters.install(None)
    d = c.as_dict()
    assert (d["recompiles"], d["compile_secs"], d["graph_replays"], d["compile_cache_hits"]) == (1, 0.25, 5, 1)
    assert fired == [0.25]
    counters.add_graph_replays()  # uninstalled: nothing counts
    assert c.as_dict()["graph_replays"] == 5


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self) -> float:
        return self.t


SCRIPT = [  # (seconds advanced, action, role)
    (0.0, "register", "learner"), (0.0, "register", "player"), (1.0, "beat", "learner"), (1.0, "beat", "learner"),
    (1.0, "beat", "player"), (1.0, "beat", "player"), (5.0, "check", ""),  # both past the cold-start grace
    (12.0, "check", ""),  # both silent 12 s > 10 s: two stalls
    (1.0, "beat", "player"), (0.0, "pause", "learner"), (30.0, "check", ""),  # a paused role never stalls
    (0.0, "resume", "learner"), (11.0, "check", ""),  # the player again; the learner re-armed by resume
    (5.0, "check", ""),  # flagged once per episode
    (0.0, "unregister", "player"), (0.0, "beat", "learner"), (20.0, "check", ""),
    (0.0, "register", "late"), (50.0, "check", ""),  # the grace: 10 × 10 s before two beats
    (60.0, "check", ""),
]


def _run_script(module, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(time, "monotonic", clock)
    stalls = []
    dog = module.StallWatchdog(timeout_s=10.0, poll_s=1.0, on_stall=lambda role, age: stalls.append((role, age)))
    log = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for dt, action, role in SCRIPT:
            clock.t += dt
            if action == "check":
                dog.check()
                log.append((sorted(dog.stalled_roles), dict(dog.beat_ages())))
            else:
                getattr(dog, action)(role)
    return stalls, log, list(dog.stall_events)


def test_the_stall_watchdog_flags_the_jax_stalls(monkeypatch):
    ours = _run_script(health, monkeypatch)
    theirs = _run_script(jax_health, monkeypatch)
    assert ours == theirs
    stalls = ours[0]
    assert [r for r, _ in stalls] == ["learner", "player", "player", "learner", "late"]


@pytest.mark.parametrize("raise_on_nonfinite", [False, True])
def test_the_nonfinite_guard_fires_on_the_jax_values(raise_on_nonfinite):
    values = [("Loss/policy_loss", 1.0), ("Loss/value_loss", float("nan")), ("Rewards/rew_avg", float("inf")),
              ("Grads/actor", np.float32("-inf")), ("Loss/value_loss", np.array(float("nan"))),
              ("Loss/policy_loss", "not a number"), ("Loss/alpha_loss", 2.5)]
    outcomes = []
    for module in (health, jax_health):
        fired_names = []
        guard = module.NonFiniteGuard(raise_on_nonfinite=raise_on_nonfinite,
                                      on_fire=lambda name, v: fired_names.append((name, str(v))))
        raised = []
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for name, value in values:
                try:
                    guard(name, value)
                except FloatingPointError:
                    raised.append(name)
        outcomes.append((guard.fired, fired_names, raised, [str(w.message) for w in caught]))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][0] == 3


def test_the_nonfinite_guard_sees_the_aggregators_values():
    from sheeprl_tpu_torch.utils.metric import MeanMetric, MetricAggregator, set_value_guard

    seen = []
    agg = MetricAggregator({"Loss/value_loss": MeanMetric()})
    set_value_guard(lambda name, value: seen.append((name, value)))
    try:
        agg.update("Loss/value_loss", np.float32(2.0))
        agg.update("Loss/missing", 1.0)
    finally:
        set_value_guard(None)
    agg.update("Loss/value_loss", 4.0)
    assert seen == [("Loss/value_loss", 2.0)] and agg.compute() == {"Loss/value_loss": 3.0}

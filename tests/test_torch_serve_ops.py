"""The port's serving ops planes against the JAX package's on the same
inputs, on the CPU: the SLO engine (one seeded event stream through an
injected clock into both engines: the same ``alerts.jsonl`` records, burn
rates, ``status()`` and verdicts, for each objective under a fast-burn and
a slow-burn-only stream), the request tracer (the same span names, lanes,
pids, durations and args from the same stamps; the same requests sampled at
rates 1, 0.5, 0.01 and 0), the access log (the same sampled lines but the
wall stamp) and ``ServeOps.snapshot`` (the same snapshot of one status).
Also the batcher's late launch, which trips a telemetry run's flight
recorder (``serve_deadline_miss``) as the JAX batcher's does."""

import glob
import json
import os
import time

import numpy as np
import cpu_threads  # noqa: F401  (one CPU thread a process: see cpu_threads.py)
import pytest
import torch

from sheeprl_tpu.obs import reqtrace as jax_reqtrace
from sheeprl_tpu.obs.slo import SloEngine as JaxSloEngine
from sheeprl_tpu.serve.ops import ServeOps as JaxServeOps
from sheeprl_tpu_torch.obs import reqtrace
from sheeprl_tpu_torch.obs.slo import SloEngine
from sheeprl_tpu_torch.obs.telemetry import finalize_telemetry, setup_telemetry
from sheeprl_tpu_torch.serve.batcher import RequestBatcher
from sheeprl_tpu_torch.serve.ops import ServeOps
from sheeprl_tpu_torch.utils import dotdict

#: the stressed objective's bad events: a stretch of them (fast) or a few just after each engine tick (slow only)
OBJECTIVES = ("act_latency_p99", "availability", "swap_staleness")
LATENCY_BOUND_MS = 250.0
STALENESS_BOUND_S = 30.0


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _stream(objective: str, mode: str, seed: int = 0):
    """``(t, latency_s, failed, cancelled, staleness_s)`` events, one every
    0.1 s over 120 s, made from a numpy seed. Good traffic is fast, answered
    and fresh; the stressed objective's events go bad in [40, 50) s
    (``fast``), or only in the first 0.6 s after each 6-second engine tick
    (``slow``: the 5-second fast window never holds one at a tick, the
    60-second slow window does)."""
    rng = np.random.default_rng(seed)
    events = []
    for i in range(1200):
        t = 0.1 * i + 0.05
        latency = float(rng.uniform(0.001, 0.05))
        failed = False
        cancelled = bool(rng.random() < 0.02)  # neither spends nor earns budget
        staleness = float(rng.uniform(0.0, 1.0))
        bad = (40.0 <= t < 50.0) if mode == "fast" else (t % 6.0 < 0.6 and t > 6.0)
        if bad and objective == "act_latency_p99":
            latency = float(rng.uniform(0.3, 0.6))
        elif bad and objective == "availability":
            failed = True
        elif bad and objective == "swap_staleness":
            staleness = float(rng.uniform(STALENESS_BOUND_S + 1, STALENESS_BOUND_S + 60))
        events.append((round(t, 6), latency, failed, cancelled, staleness))
    return events


def _drive(engine, clock, events, tick_s):
    """Feed the events in time order, an engine tick every ``tick_s``
    seconds; returns each tick's (objective, alert, burn) readings."""
    burns, next_tick = [], tick_s
    for t, latency, failed, cancelled, staleness in events:
        while t >= next_tick:
            clock.t = next_tick
            engine.evaluate()
            for name, obj in engine.objectives.items():
                for alert in (obj.fast, obj.slow):
                    burns.append((next_tick, name, alert.name, obj.burn(next_tick, alert.window_s)))
            next_tick += tick_s
        clock.t = t
        engine.record_request(latency, failed=failed, cancelled=cancelled)
        engine.record_staleness(staleness)
    return burns


def _without_wall(records):
    return [{k: v for k, v in r.items() if k != "ts_unix"} for r in records]


@pytest.mark.parametrize("mode", ["fast", "slow"])
@pytest.mark.parametrize("objective", OBJECTIVES)
def test_the_slo_engine_matches_jax_on_one_event_stream(tmp_path, objective, mode):
    cfg = {"enabled": True, "objectives": {"act_latency_p99_ms": LATENCY_BOUND_MS, "swap_staleness_s": STALENESS_BOUND_S}}
    events = _stream(objective, mode, seed=OBJECTIVES.index(objective))
    tick_s = 1.0 if mode == "fast" else 6.0
    sides = {}
    for name, cls in (("port", SloEngine), ("jax", JaxSloEngine)):
        clock = _Clock()
        fired = []
        engine = cls(cfg, alerts_path=str(tmp_path / name / "alerts.jsonl"), on_alert=fired.append, clock=clock)
        burns = _drive(engine, clock, events, tick_s)
        clock.t = 121.0
        sides[name] = (engine, burns, fired, engine.status(), engine.verdicts())
        engine.close()
    port, jax_side = sides["port"], sides["jax"]
    assert port[1] == jax_side[1]  # every tick's burn rates, exactly: counts over the same buckets
    assert _without_wall(port[0].alert_log) == _without_wall(jax_side[0].alert_log)
    assert _without_wall(port[2]) == _without_wall(jax_side[2])  # on_alert saw the same firings
    assert port[3] == jax_side[3] and port[4] == jax_side[4]
    lines = {n: [json.loads(x) for x in open(tmp_path / n / "alerts.jsonl")] for n in sides}
    assert _without_wall(lines["port"]) == _without_wall(lines["jax"]) == _without_wall(port[0].alert_log)
    # the stream does what it says: its objective's alert fires (and only the slow one for a slow-only stream)
    fired = {(r["objective"], r["alert"]) for r in port[0].alert_log if r["event"] == "fire"}
    assert (objective, "slow_burn") in fired
    assert ((objective, "fast_burn") in fired) == (mode == "fast")
    assert {o for o, _a in fired} == {objective}
    assert port[4][objective] == "FAIL"
    assert port[3]["cancelled_tickets"] == sum(e[3] for e in events)
    if mode == "fast":  # a fired alert clears once the burn falls below half its threshold
        assert [r["event"] for r in port[0].alert_log if r["alert"] == "fast_burn"] == ["fire", "clear"]


@pytest.mark.parametrize("rate", [1.0, 0.5, 0.01, 0.0])
def test_the_tracer_samples_the_same_requests_as_jax(tmp_path, rate):
    port = reqtrace.ServeTracer(str(tmp_path / "port"), rate)
    theirs = jax_reqtrace.ServeTracer(str(tmp_path / "jax"), rate)
    try:
        picked = [(a.trace_id if a else None, b.trace_id if b else None)
                  for a, b in ((port.sample(), theirs.sample()) for _ in range(400))]
    finally:
        port.close()
        theirs.close()
    assert all(a == b for a, b in picked)
    assert sum(a is not None for a, _ in picked) == {1.0: 400, 0.5: 200, 0.01: 4, 0.0: 0}[rate]
    assert port.every == theirs._every


def _spans(path):
    events = [json.loads(line) for line in open(path)]
    meta = sorted((e["name"], e["pid"]) for e in events if e.get("ph") == "M" and e["name"] != "thread_name")
    return meta, [e for e in events if e.get("ph") == "X"]


def test_the_tracer_writes_the_jax_spans_from_the_same_stamps(tmp_path):
    rng = np.random.default_rng(7)
    port = reqtrace.ServeTracer(str(tmp_path / "port"), 1.0)
    theirs = jax_reqtrace.ServeTracer(str(tmp_path / "jax"), 1.0)
    try:
        for i in range(12):
            stamps = np.cumsum(rng.uniform(1e-5, 3e-3, size=7)) + 100.0 + i
            t_start, t_enqueue, *rest = (float(x) for x in stamps)
            t_enqueue = 0.0 if i % 4 == 3 else t_enqueue  # an in-process baton stamped no enqueue
            client, version = ("" if i % 5 == 0 else f"c{i % 3}"), (0 if i % 6 == 0 else 100 + i)
            port.emit_request(reqtrace.RequestTrace(1000 + i, t_start, t_enqueue), *rest, client_id=client,
                              version=version)
            theirs.emit_request(jax_reqtrace.RequestTrace(1000 + i, t_start, t_enqueue), *rest, client_id=client,
                                version=version)
        assert port.sampled == theirs.sampled == 12
    finally:
        port.close()
        theirs.close()
    for lane in ("client", "gateway"):
        meta, ours = _spans(tmp_path / "port" / f"trace_serve_{lane}.jsonl")
        jax_meta, jax_spans = _spans(tmp_path / "jax" / f"trace_serve_{lane}.jsonl")
        assert meta == jax_meta and ("clock_sync", reqtrace.GATEWAY_PID if lane == "gateway" else reqtrace.CLIENT_PID) in meta
        keep = ("name", "cat", "ph", "pid", "dur", "args")
        assert [{k: e[k] for k in keep} for e in ours] == [{k: e[k] for k in keep} for e in jax_spans]
        assert len(ours) == 12 * (2 if lane == "client" else 4)
    assert reqtrace.STAGES == jax_reqtrace.STAGES
    assert (reqtrace.CLIENT_PID, reqtrace.GATEWAY_PID) == (jax_reqtrace.CLIENT_PID, jax_reqtrace.GATEWAY_PID)


def _status():
    """A gateway status as both gateways report it."""
    return {"algo": "dreamer_v3", "env": "CartPole-v1", "device": "cpu", "model_version": 8, "checkpoint": "/x",
            "swapper": False, "requests": 40, "batches": 11, "mean_batch_occupancy": 3.636, "deadline_misses": 2,
            "failed_requests": 1, "swaps": 1, "versions_served": [8, 1008],
            "act_latency": {"count": 39, "p50_ms": 2.5, "p95_ms": 7.1, "p99_ms": 9.0, "max_ms": 9.2},
            "stage_latency": {"queue_wait": {"count": 39, "p50_ms": 1.0}, "respond": {"count": 39, "p50_ms": 0.01}},
            "batch_occupancy": {"count": 11, "p50": 4.0, "p95": 4.0, "p99": 4.0, "max": 4.0},
            "versions": {"8": {"requests": 30, "p50_ms": 2.4}, "1008": {"requests": 9, "p50_ms": 2.7}},
            "last_deadline_miss": {"rows": 4, "lateness_ms": 8.0, "deadline_ms": 10.0}}


@pytest.mark.parametrize("rate", [1.0, 0.25, 0.0])
def test_the_access_log_and_the_snapshot_match_jax(tmp_path, rate):
    settings = {"access_log_sample_rate": rate, "trace_sample_rate": 0.5,
                "slo": {"enabled": True, "eval_interval_s": 3600.0}}
    ops = {name: cls.build(settings, str(tmp_path / name), status_fn=_status)
           for name, cls in (("port", ServeOps), ("jax", JaxServeOps))}
    batons = {"port": reqtrace.RequestTrace, "jax": jax_reqtrace.RequestTrace}
    rng = np.random.default_rng(3)
    try:
        for i in range(40):
            latency, ok = float(rng.uniform(1e-3, 0.4)), bool(rng.random() > 0.1)
            stamps = tuple(float(x) for x in np.cumsum(rng.uniform(1e-4, 1e-2, size=5)) + i)
            for name, o in ops.items():
                trace = batons[name](7 + i, stamps[0] - 1e-3, stamps[0] - 5e-4) if i % 2 == 0 else None
                o.on_request(f"c{i % 4}", latency if ok else None, 8 + (i > 30) * 1000, ok=ok, trace=trace,
                             stamps=stamps, rows=1 + i % 4)
            if i % 9 == 0:
                for o in ops.values():
                    o.on_cancelled(2)
        for o in ops.values():
            o.slo_tick()
        snaps = {name: {k: v for k, v in o.snapshot().items() if k != "ts_unix"} for name, o in ops.items()}
        assert snaps["port"] == snaps["jax"]
        assert snaps["port"]["slo"]["cancelled_tickets"] == 10 and snaps["port"]["serve_versions"]
    finally:
        for o in ops.values():
            o.close()
    reqtrace.install(None)
    jax_reqtrace.install(None)
    lines = {name: [json.loads(x) for x in open(tmp_path / name / "access.jsonl")] if rate else []
             for name in ops}
    assert _without_wall(lines["port"]) == _without_wall(lines["jax"])
    assert len(lines["port"]) == {1.0: 40, 0.25: 10, 0.0: 0}[rate]
    assert all(isinstance(line["ts_unix"], float) for line in lines["port"])
    live = {name: json.load(open(tmp_path / name / "serve_live.json")) for name in ops}
    drop = ("ts_unix", "rolling")
    assert {k: v for k, v in live["port"].items() if k not in drop} == {
        k: v for k, v in live["jax"].items() if k not in drop}


def test_build_returns_none_with_every_knob_off(tmp_path):
    for settings in ({}, {"trace_sample_rate": 0.0, "access_log_sample_rate": 0.0, "metrics_port": None,
                          "inject_dispatch_delay_s": 0.0, "slo": {"enabled": False}}):
        assert ServeOps.build(settings, str(tmp_path), status_fn=_status) is None
        assert JaxServeOps.build(settings, str(tmp_path), status_fn=_status) is None
    assert reqtrace.sample() is None and reqtrace.installed() is None


def test_lint_serve_holds_the_boundary_both_ways(tmp_path, monkeypatch):
    from sheeprl_tpu_torch.tools import lint_serve

    assert lint_serve.lint() == ([], [])
    assert lint_serve.main() == 0
    client = tmp_path / "client.py"
    client.write_text("from sheeprl_tpu_torch.serve.model import load_gateway_model\n\ndef f(gw):\n"
                      "    return gw.client(), load_gateway_model\n")
    clean = tmp_path / "clean.py"
    clean.write_text("def g(gw):\n    return gw.client()\n")
    assert lint_serve.scan_file(str(client)) == (True, {"load_gateway_model"})
    assert lint_serve.scan_file(str(clean)) == (True, set())
    monkeypatch.setattr(lint_serve, "iter_sources", lambda: iter([str(client), str(clean)]))
    monkeypatch.setattr(lint_serve, "REPO", str(tmp_path))
    monkeypatch.setattr(lint_serve, "ALLOWLIST", {"clean.py"})
    assert lint_serve.lint() == ([("client.py", ["load_gateway_model"])], ["clean.py"])
    assert lint_serve.main() == 1


class _SlowModel:
    """Holds the device 0.1 s a batch: a request queued behind it launches late."""

    version, device = 1, torch.device("cpu")

    def init_state_rows(self, n):
        return None

    def act(self, obs, state, generator):
        time.sleep(0.1)
        return np.zeros((len(obs["x"]), 1)), None


def test_a_late_launch_in_a_telemetry_run_dumps_a_flight_recording(tmp_path):
    tel = setup_telemetry(dotdict({"metric": {"telemetry": {
        "enabled": True, "live_interval_s": 0, "poll_interval_s": 0, "stall_timeout_s": 0,
        "flight": {"min_interval_s": 0}}}}))
    tel.attach_run_dir(str(tmp_path))
    batcher = RequestBatcher(_SlowModel(), max_batch=4, deadline_s=0.01)
    try:
        first = batcher.submit("a", {"x": np.zeros(1)})  # dispatches, holds the device 100 ms
        time.sleep(0.03)
        second = batcher.submit("b", {"x": np.zeros(1)})  # cannot launch before ~100 ms: late
        batcher.wait(first, timeout=10.0)
        batcher.wait(second, timeout=10.0)
        miss = batcher.stats()["last_deadline_miss"]
        assert batcher.stats()["deadline_misses"] >= 1 and miss["lateness_ms"] > 5.0
    finally:
        batcher.close()
        finalize_telemetry(print_summary=False)
    dumps = glob.glob(os.path.join(str(tmp_path), "telemetry", "flight_serve_deadline_miss_*.json"))
    assert dumps, "a late launch dumps a flight recording"
    payloads = [json.loads(open(path).read()) for path in dumps]
    assert {p["reason"] for p in payloads} == {"serve_deadline_miss"}
    assert miss in [p["detail"] for p in payloads]  # every miss dumps (no rate limit here): the last one too
    assert miss["deadline_ms"] == 10.0 and miss["rows"] == 1

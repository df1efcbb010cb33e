"""The port's serving ops surface end to end on the CPU, on a tiny
DreamerV3 CartPole checkpoint (counterpart of ``tests/test_serve/
test_ops.py``):

- every knob on, a few dozen requests through an in-process client and two
  spawned ring clients: the two trace lanes (six spans a sampled request,
  ring requests carrying their client's stamps across the process boundary),
  the access log, one ``/metrics`` scrape, ``serve_live.json``, the port's
  ``trace_view`` merge, the port's ``serve_report --json`` (exit 0) against
  the JAX package's ``tools/serve_report.py --json`` on the same obs dir,
  the JAX ``ServeOps.snapshot`` against the port's on the gateway's status,
  and each sampled request's six stages against its act latency;
- the fault drill: ``inject_dispatch_delay_s`` trips the fast burn, dumps a
  ``flight_slo_burn_*.json`` and makes ``serve_report`` exit 1;
- off is off: with every knob off the gateway has no sink and serves the
  actions of a gateway that never called ``enable_ops``, bit for bit."""

import glob
import importlib.util
import json
import os
import urllib.request

import numpy as np
import cpu_threads  # noqa: F401  (one CPU thread a process: see cpu_threads.py)
import pytest

from sheeprl_tpu.serve.ops import ServeOps as JaxServeOps
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.obs import counters as obs_counters
from sheeprl_tpu_torch.obs import reqtrace, slo
from sheeprl_tpu_torch.serve import ServeGateway
from sheeprl_tpu_torch.serve.gateway import spawn_clients
from sheeprl_tpu_torch.serve.ops import ServeOps
from sheeprl_tpu_torch.tools import serve_report, trace_view
from test_torch_evals import cartpole_args

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOCAL_REQUESTS, RING_CLIENTS, RING_REQUESTS = 16, 2, 8
ALL_KNOBS = {
    "trace_sample_rate": 0.5,
    "access_log_sample_rate": 1.0,
    "metrics_port": 0,  # ephemeral
    "inject_dispatch_delay_s": 0.001,
    "slo": {"enabled": True, "eval_interval_s": 30.0},
}


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A tiny DreamerV3 run on CartPole (random actions, a checkpoint at its end)."""
    root = tmp_path_factory.mktemp("serve_ops")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        return cli.run(cartpole_args(root / "logs", "ops", "dreamer_v3", ["fabric.accelerator=cpu"]))["checkpoint"]
    finally:
        os.chdir(cwd)


def _gateway(checkpoint, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("deadline_s", 0.005)
    return ServeGateway.from_checkpoint(checkpoint, device="cpu", **kw)


def _rows(gateway, n, seed):
    rng = np.random.default_rng(seed)
    spaces = gateway.observation_space.spaces
    return [{k: rng.standard_normal(s.shape).astype(s.dtype) for k, s in spaces.items()} for _ in range(n)]


def _jax_serve_report():
    spec = importlib.util.spec_from_file_location("jax_serve_report", os.path.join(REPO, "tools", "serve_report.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _x_spans(path):
    out = {}
    for line in open(path):
        ev = json.loads(line)
        if ev.get("ph") == "X":
            out.setdefault(ev["args"]["trace_id"], []).append(ev)
    return out


def test_the_full_surface_traces_logs_scrapes_and_reports(checkpoint, tmp_path):
    out = tmp_path / "serve_obs"
    gateway = _gateway(checkpoint)
    latency_by_trace, batons = {}, []
    try:
        ops = gateway.enable_ops(ALL_KNOBS, out_dir=str(out))
        assert ops is not None and gateway.ops is ops and gateway.batcher._ops is ops
        assert reqtrace.installed() is ops.tracer and ops.inject_dispatch_delay_s == 0.001
        ring = gateway.start_ring(RING_CLIENTS)
        assert ring.trace_every == 2  # the sampling knob rides the ring to the client processes
        procs = spawn_clients(ring, RING_CLIENTS, "sheeprl_tpu_torch.serve.loadgen:seeded_client",
                              {"requests": RING_REQUESTS, "seed": 5, "episode_len": 4, "out_dir": str(tmp_path / "c")})
        submit = gateway.batcher.submit

        def recording_submit(client_id, obs, reset=False, trace=None):
            batons.append((client_id, trace))
            return submit(client_id, obs, reset=reset, trace=trace)

        gateway.batcher.submit = recording_submit
        for p in procs:
            p.join(timeout=120)
            assert p.exitcode == 0
        # the in-process client acts once the ring clients are done: no process of the test competes for its wake-up
        client = gateway.client("local")
        for step, row in enumerate(_rows(gateway, LOCAL_REQUESTS, 0)):
            t0 = reqtrace.now()
            _action, version = client.act(row, reset=step == 0)
            latency_by_trace[step + 1] = (t0, reqtrace.now())  # the local tracer numbers requests 1, 2, ...
            assert version == 8
        client_us = ops.tracer.client._us  # the client lane's clock: perf_counter seconds -> the trace's us
        with urllib.request.urlopen(f"http://127.0.0.1:{ops.prom.port}/metrics", timeout=10) as resp:
            body = resp.read().decode()
        for needle in ('phase_duration_ms{phase="serve/queue_wait"', 'phase_duration_ms{phase="serve/act_latency"',
                       "slo_objective_ok", "serve_version_requests", "slo_burn_rate_fast"):
            assert needle in body, needle
        status = gateway.status()
        assert set(status["slo"]["objectives"]) == {"act_latency_p99", "availability", "swap_staleness"}
        assert status["trace"] == {"sample_rate": 0.5, "sampled_requests": ops.tracer.sampled}
        snap_status = dict(status)
    finally:
        gateway.close()
    assert reqtrace.installed() is None  # the close uninstalls the tracer
    total = LOCAL_REQUESTS + RING_CLIENTS * RING_REQUESTS

    # the ring's metadata reached the batcher: every other request of a slot carries its client's baton
    ring_batons = [(cid, t) for cid, t in batons if cid.startswith("ring")]
    assert len(ring_batons) == RING_CLIENTS * RING_REQUESTS
    for slot in range(RING_CLIENTS):
        ids = [t.trace_id for cid, t in ring_batons if cid == f"ring{slot}" and t is not None]
        assert ids == [(slot + 1) * 1_000_000 + seq for seq in range(1, RING_REQUESTS + 1, 2)]
        assert all(0 < t.t_start <= t.t_enqueue for cid, t in ring_batons if cid == f"ring{slot}" and t is not None)

    # the trace plane: six stages a sampled request, in causal order, on two lanes
    client_spans, beyond_ms = _x_spans(out / "trace_serve_client.jsonl"), {}
    gateway_spans = _x_spans(out / "trace_serve_gateway.jsonl")
    assert set(client_spans) == set(gateway_spans)
    assert len(client_spans) == LOCAL_REQUESTS // 2 + RING_CLIENTS * RING_REQUESTS // 2
    access = [json.loads(line) for line in open(out / "access.jsonl")]
    assert len(access) == total and all(rec["ok"] for rec in access)
    logged = {rec["trace_id"]: rec["latency_ms"] for rec in access if rec["trace_id"]}
    assert set(logged) == set(client_spans)
    for trace_id, lane in client_spans.items():
        chain = lane + gateway_spans[trace_id]
        assert [ev["name"] for ev in chain] == [f"serve/{s}" for s in reqtrace.STAGES]
        assert {ev["pid"] for ev in lane} == {reqtrace.CLIENT_PID}
        assert {ev["pid"] for ev in gateway_spans[trace_id]} == {reqtrace.GATEWAY_PID}
        for prev, cur in zip(chain, chain[1:]):
            assert cur["ts"] >= prev["ts"] + prev["dur"] - 0.2
        gateway_ms = sum(ev["dur"] for ev in gateway_spans[trace_id]) / 1e3
        assert gateway_ms == pytest.approx(logged[trace_id], abs=0.05)
        # the six stages tile the request's act latency, from the client's act() entry to the gateway's answer
        six_ms = sum(ev["dur"] for ev in chain) / 1e3
        assert six_ms == pytest.approx((chain[-1]["ts"] + chain[-1]["dur"] - chain[0]["ts"]) / 1e3, abs=1.0)
        if trace_id in latency_by_trace:
            # the in-process client's own clock around act() holds the six stages (the spans' durations are
            # rounded to 0.1 us each): its act() entry comes no later than the first stamp and its return no
            # earlier than the gateway's answer, read on the one clock both use; what its clock reads beyond the
            # stages is its wake-up after the answer, which a loaded host's scheduler stretches (its time is
            # measured on the card: eval_serve, --serve-ops)
            t0, t1 = latency_by_trace[trace_id]
            assert client_us(t0) <= chain[0]["ts"] + 0.1, (trace_id, client_us(t0), chain[0]["ts"])
            assert chain[-1]["ts"] + chain[-1]["dur"] <= client_us(t1) + 0.2, (trace_id, chain[-1], client_us(t1))
            beyond_ms[trace_id] = (t1 - t0) * 1e3 - six_ms
            assert beyond_ms[trace_id] >= -0.001, (trace_id, beyond_ms[trace_id])
    assert len(beyond_ms) == LOCAL_REQUESTS // 2

    merged = trace_view.merge(trace_view.discover([str(out)]))["traceEvents"]
    by_trace = {}
    for ev in merged:
        if ev.get("ph") == "X":
            by_trace.setdefault(ev["args"]["trace_id"], set()).add((ev["pid"], ev["name"]))
    assert set(by_trace) == set(client_spans) and all(len(v) == 6 for v in by_trace.values())

    live = json.loads((out / "serve_live.json").read_text())
    assert live["requests"] == total and live["trace_sampled_requests"] == len(client_spans)
    assert live["access_log_lines"] == total and live["failed_requests"] == 0
    # each verdict is the one the logged requests make: the latency objective's from the access log's latencies
    # (the latencies its engine was fed), against its bound and budget. Whether a loaded host keeps the requests
    # inside the bound is a property of the host, not of the engine; the card holds the bound (eval_serve)
    bound_ms = slo.slo_settings(ALL_KNOBS["slo"])["objectives"]["act_latency_p99_ms"]
    slow = sum(rec["latency_ms"] > bound_ms for rec in access)
    want = {"act_latency_p99": "PASS" if slow / total <= 0.01 else "FAIL", "availability": "PASS",
            "swap_staleness": "PASS"}
    assert {k: obj["verdict"] for k, obj in live["slo"]["objectives"].items()} == want, (slow, want)
    overall = "PASS" if set(want.values()) == {"PASS"} else "FAIL"

    exit_code = 0 if overall == "PASS" else 1
    assert serve_report.main([str(out), "--out", str(tmp_path / "port_report.md"), "--json"]) == exit_code
    assert _jax_serve_report().main([str(out), "--out", str(tmp_path / "jax_report.md"), "--json"]) == exit_code
    ours, theirs = (json.loads((tmp_path / f"{n}_report.json").read_text()) for n in ("port", "jax"))
    assert ours.pop("generated_at") and theirs.pop("generated_at")
    assert ours == theirs and ours["verdict"] == overall
    assert f"**Overall: {overall}**" in (tmp_path / "port_report.md").read_text()

    # both packages' ops snapshot the gateway's status alike
    snaps = []
    for cls, d in ((ServeOps, "port_snap"), (JaxServeOps, "jax_snap")):
        ops = cls.build({"access_log_sample_rate": 1.0}, str(tmp_path / d), status_fn=lambda: snap_status)
        snaps.append({k: v for k, v in ops.snapshot().items() if k != "ts_unix"})
        ops.close()
    assert snaps[0] == snaps[1] and snaps[0]["requests"] == status["requests"]


def test_an_injected_dispatch_delay_trips_the_fast_burn(checkpoint, tmp_path):
    out = tmp_path / "serve_obs"
    gateway = _gateway(checkpoint)
    counters = obs_counters.Counters()
    obs_counters.install(counters)
    try:
        ops = gateway.enable_ops({"inject_dispatch_delay_s": 0.12,
                                  "slo": {"enabled": True, "eval_interval_s": 3600.0,  # the test drives the ticks
                                          "objectives": {"act_latency_p99_ms": 20.0}}}, out_dir=str(out))
        assert ops.tracer is None and ops.access is None and ops.prom is None
        client = gateway.client("victim")
        for row in _rows(gateway, 6, 1):
            client.act(row)
        ops.slo_tick()
        fired = [r for r in ops.slo.alert_log if r["event"] == "fire" and r["objective"] == "act_latency_p99"]
        assert {r["alert"] for r in fired} >= {"fast_burn"}
        assert counters.slo_alerts_fired >= 1 and ops.slo.verdicts()["act_latency_p99"] == "FAIL"
        assert glob.glob(str(out / "flight_slo_burn_*.json")), "an SLO burn dumps a flight recording"
        # the delay is charged to the device stage
        assert gateway.status()["stage_latency"]["device_dispatch"]["p50_ms"] >= 100.0
    finally:
        obs_counters.install(None)
        gateway.close()
    records = [json.loads(line) for line in open(out / "alerts.jsonl")]
    assert any(r["event"] == "fire" and r["objective"] == "act_latency_p99" for r in records)
    assert serve_report.main([str(out)]) == 1
    assert "**Overall: FAIL**" in (out / "serve_report.md").read_text()


def test_every_knob_off_serves_the_actions_of_a_gateway_without_ops(checkpoint):
    plain, off = _gateway(checkpoint, max_batch=1), _gateway(checkpoint, max_batch=1)
    counters = obs_counters.Counters()
    obs_counters.install(counters)
    try:
        assert off.enable_ops({"trace_sample_rate": 0.0, "access_log_sample_rate": 0.0, "metrics_port": None,
                               "inject_dispatch_delay_s": 0.0, "slo": {"enabled": False}}) is None
        assert off.ops is None and off.batcher._ops is None and reqtrace.installed() is None
        assert reqtrace.sample() is None
        served = {}
        for name, gw in (("plain", plain), ("off", off)):
            client = gw.client("same")
            served[name] = [client.act(row, reset=i % 5 == 0) for i, row in enumerate(_rows(gw, 12, 2))]
    finally:
        obs_counters.install(None)
        plain.close()
        off.close()
    for (a, va), (b, vb) in zip(served["plain"], served["off"]):
        assert va == vb and a.dtype == b.dtype and np.array_equal(a, b)
    assert counters.serve_traced_requests == 0 and counters.slo_alerts_fired == 0

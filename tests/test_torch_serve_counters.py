"""The port's serving batcher feeds the run's serve counters as the JAX
batcher does.

One script drives each package's ``RequestBatcher`` with its counters
installed: two answered requests, a swap, one more, a swap to a model whose
dispatch raises and one request that fails there, a swap to a model that
holds its batch while two more requests queue behind it, and a drain that
finishes them. The two counter snapshots' ``serve_*`` fields must be equal,
and equal to the script's own tally; a client that has its answer (or its
error) already sees its batch counted. The two batchers differ at a drain
that times out (the JAX one waits for its dispatcher before failing what is
left, the port's fails the queue at the timeout), so the port's count of
requests failed at a drain is held against its own stats.
"""

import threading

import numpy as np
import pytest

import cpu_threads  # noqa: F401  (one CPU thread a process)

SERVE_FIELDS = (
    "serve_requests",
    "serve_batches",
    "serve_batch_rows",
    "serve_deadline_misses",
    "serve_swaps",
    "serve_failed_requests",
)

#: the script's own tally: 7 requests, 6 answered one a batch, 3 swaps, 1 failed dispatch
EXPECTED = {
    "serve_requests": 7,
    "serve_batches": 6,
    "serve_batch_rows": 6,
    "serve_deadline_misses": 0,
    "serve_swaps": 3,
    "serve_failed_requests": 1,
}


class _Model:
    """A model for either batcher: the action is twice the observation.
    ``fail`` raises at dispatch; ``hold`` blocks the dispatch until
    released, after flagging that it started."""

    def __init__(self, version, fail=False, hold=False):
        import torch

        self.version = version
        self.device = torch.device("cpu")
        self.algo, self.env_id, self.checkpoint = "fake", "FakeEnv-v0", None
        self.fail, self.hold = fail, hold
        self.started, self.release = threading.Event(), threading.Event()

    def init_state_rows(self, n):
        return None

    def act(self, obs, state, key):
        if self.hold:
            self.started.set()
            assert self.release.wait(30.0)
        if self.fail:
            raise RuntimeError("injected dispatch failure")
        return np.asarray(obs["obs"], dtype=np.float64) * 2.0, None


def _row(value):
    return {"obs": np.asarray([float(value)], dtype=np.float64)}


def _script(batcher_cls, client_cls, counters, errors):
    """Run the script on one package; returns its counter snapshot."""
    saved = counters.installed()
    counters.install(counters.Counters())
    try:
        batcher = batcher_cls(_Model(1), max_batch=1, deadline_s=0.0, seed=123)
        try:
            client = client_cls(batcher, client_id="c")
            for v in (1, 2):
                action, version = client.act(_row(v))
                assert float(action[0]) == 2.0 * v and version == 1
                # the batch is counted before its waiter woke
                assert counters.installed().as_dict()["serve_batches"] == v
            batcher.swap(_Model(2))
            assert client.act(_row(3))[1] == 2
            batcher.swap(_Model(3, fail=True))
            with pytest.raises(errors):
                client.act(_row(4))
            assert counters.installed().as_dict()["serve_failed_requests"] == 1
            held = _Model(4, hold=True)
            batcher.swap(held)
            first = batcher.submit("a", _row(5))
            assert held.started.wait(30.0)
            queued = [batcher.submit("b", _row(6)), batcher.submit("c", _row(7))]
            held.release.set()
            assert batcher.drain(timeout=30.0) is True
            assert all(p.event.is_set() and p.error is None for p in [first] + queued)
        finally:
            batcher.close()
        return {k: counters.installed().as_dict()[k] for k in SERVE_FIELDS}
    finally:
        counters.install(saved)


def test_port_batcher_counts_what_the_jax_batcher_counts():
    from sheeprl_tpu.obs import counters as jax_counters
    from sheeprl_tpu.serve.batcher import RequestBatcher as JaxBatcher
    from sheeprl_tpu.serve.batcher import ServeRequestError as JaxError
    from sheeprl_tpu.serve.client import LocalServeClient as JaxClient
    from sheeprl_tpu_torch.obs import counters as port_counters
    from sheeprl_tpu_torch.serve.batcher import RequestBatcher as PortBatcher
    from sheeprl_tpu_torch.serve.batcher import ServeRequestError as PortError
    from sheeprl_tpu_torch.serve.client import LocalServeClient as PortClient

    port = _script(PortBatcher, PortClient, port_counters, PortError)
    assert port == EXPECTED
    jax = _script(JaxBatcher, JaxClient, jax_counters, JaxError)
    assert jax == port


def test_port_drain_counts_the_requests_it_fails():
    """A drain at timeout 0 behind a held batch fails the two queued
    requests: both are counted (counter and stats) before they wake."""
    from sheeprl_tpu_torch.obs import counters as port_counters
    from sheeprl_tpu_torch.serve.batcher import RequestBatcher

    saved = port_counters.installed()
    port_counters.install(port_counters.Counters())
    try:
        held = _Model(1, hold=True)
        batcher = RequestBatcher(held, max_batch=1, deadline_s=0.0, seed=1)
        seen = []
        try:
            first = batcher.submit("a", _row(1))
            assert held.started.wait(30.0)
            queued = [batcher.submit("b", _row(2)), batcher.submit("c", _row(3))]

            def on_wake():
                for p in queued:
                    p.event.wait(30.0)
                seen.append(port_counters.installed().as_dict()["serve_failed_requests"])
                held.release.set()

            waker = threading.Thread(target=on_wake, daemon=True)
            waker.start()
            assert batcher.drain(timeout=0.0) is False
            waker.join(30.0)
            assert first.error is None and all(p.error is not None for p in queued)
        finally:
            batcher.close()
        assert seen == [2]
        snap = port_counters.installed().as_dict()
        assert snap["serve_failed_requests"] == 2 == batcher.stats()["failed_requests"]
        assert snap["serve_requests"] == 3 and snap["serve_batches"] == 1
    finally:
        port_counters.install(saved)


def test_port_batcher_counts_with_no_counters_installed():
    """With the telemetry off (no counters installed) the batcher serves as
    before and its own stats keep the tally."""
    from sheeprl_tpu_torch.obs import counters as port_counters
    from sheeprl_tpu_torch.serve.batcher import RequestBatcher
    from sheeprl_tpu_torch.serve.client import LocalServeClient

    saved = port_counters.installed()
    port_counters.install(None)
    try:
        batcher = RequestBatcher(_Model(1), max_batch=1, deadline_s=0.0, seed=1)
        try:
            client = LocalServeClient(batcher, client_id="c")
            assert float(client.act(_row(3))[0][0]) == 6.0
            stats = batcher.stats()
            assert stats["batches"] == 1 and stats["requests"] == 1
        finally:
            batcher.close()
    finally:
        port_counters.install(saved)


def test_a_telemetry_run_that_serves_reads_non_zero_serve_counters(tmp_path):
    """With the run telemetry on (``metric=telemetry``), requests served
    through the port's batcher land in the run's ``telemetry.json``."""
    import json

    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.obs.telemetry import finalize_telemetry, setup_telemetry
    from sheeprl_tpu_torch.serve.batcher import RequestBatcher
    from sheeprl_tpu_torch.serve.client import LocalServeClient

    cfg = compose(overrides=["exp=ppo", "metric=telemetry", "metric.telemetry.live.enabled=false"])
    telemetry = setup_telemetry(cfg, device="cpu")
    assert telemetry is not None
    telemetry.attach_run_dir(str(tmp_path))
    try:
        batcher = RequestBatcher(_Model(1), max_batch=1, deadline_s=0.0, seed=1)
        try:
            client = LocalServeClient(batcher, client_id="c")
            for v in range(3):
                client.act(_row(v))
        finally:
            batcher.close()
    finally:
        finalize_telemetry(print_summary=False)
    with open(tmp_path / "telemetry.json") as f:
        summary = json.load(f)
    assert summary["serve_requests"] == 3 and summary["serve_batches"] == 3 and summary["serve_batch_rows"] == 3

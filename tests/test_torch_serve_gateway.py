"""The port's serving gateway on the CPU, against its own eval service and
the JAX package's settings: checkpoint and ``registry:best:`` loads, the
gateway-path rescore (bit for bit the eval service's returns, lengths and
every step's actions at matched seeds), hot-swap under load from a policy
publication channel, a torn publication refused, the drain, the
shared-memory ring across spawned processes, the ``serve`` command with
``serve.duration_s`` and spawned load clients, and the ops knobs, which
raise."""

import os
import threading

import numpy as np
import pytest
import torch

from sheeprl_tpu.serve import serve_settings as jax_serve_settings
from sheeprl_tpu.utils.utils import dotdict as jax_dotdict
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.ckpt import read_checkpoint
from sheeprl_tpu_torch.evals import service
from sheeprl_tpu_torch.plane.publish import PolicyPublisher, policy_path
from sheeprl_tpu_torch.serve import ServeClosed, ServeGateway, rescore_through_gateway, serve_settings
from sheeprl_tpu_torch.serve.batcher import RequestBatcher
from sheeprl_tpu_torch.serve.gateway import spawn_clients
from sheeprl_tpu_torch.serve.rings import ActSlabRing
from sheeprl_tpu_torch.utils import dotdict
from test_torch_evals import cartpole_args

EPISODES, SEED0 = 5, 21


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Tiny runs of the port's DreamerV3 and DreamerV2 on CartPole."""
    root = tmp_path_factory.mktemp("port_serve")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        return {
            algo: cli.run(cartpole_args(root / "logs" / algo, "port", algo, ["fabric.accelerator=cpu"]))["checkpoint"]
            for algo in ("dreamer_v3", "dreamer_v2")
        }
    finally:
        os.chdir(cwd)


@pytest.fixture
def gateway(runs):
    gw = ServeGateway.from_checkpoint(runs["dreamer_v3"], max_batch=4, deadline_s=0.002, device="cpu")
    yield gw
    gw.close()


def _row(rng, gw):
    return {k: rng.standard_normal(s.shape).astype(s.dtype) for k, s in gw.observation_space.spaces.items()}


def _record_actions(monkeypatch, seen):
    """Record every act of the eval service's policies."""
    import sheeprl_tpu_torch

    sheeprl_tpu_torch.register_algorithms()
    for algo in ("dreamer_v3", "dreamer_v2"):
        build = service.find_eval_builder(algo)

        def builder(*args, _build=build, **kwargs):
            policy = _build(*args, **kwargs)

            def act(obs, state, generator):
                actions, state = policy.act(obs, state, generator)
                seen.append(np.asarray(actions).copy())
                return actions, state

            return service.EvalPolicy(act=act, init_state=policy.init_state, device=policy.device)

        monkeypatch.setitem(service._EVAL_BUILDERS, algo, builder)


@pytest.mark.parametrize("algo", ["dreamer_v3", "dreamer_v2"])
def test_rescore_through_gateway_is_bitwise_the_eval_service(runs, monkeypatch, algo):
    direct_steps, gated_steps = [], []
    _record_actions(monkeypatch, direct_steps)
    direct = service.evaluate_checkpoint(runs[algo], episodes=EPISODES, seed0=SEED0, write_registry=False,
                                         device="cpu")
    gated = rescore_through_gateway(runs[algo], episodes=EPISODES, seed0=SEED0, device="cpu",
                                    on_step=lambda a: gated_steps.append(a.copy()))
    assert gated["protocol"] == "frozen-greedy/gateway"
    assert gated["seeds"] == direct["seeds"] == [SEED0 + i for i in range(EPISODES)]
    assert gated["returns"] == direct["returns"] and gated["lengths"] == direct["lengths"]
    assert gated["mean"] == direct["mean"] and gated["iqm"] == direct["iqm"]
    assert len(gated_steps) == len(direct_steps) == max(direct["lengths"]) > 1
    for a, b in zip(gated_steps, direct_steps):
        np.testing.assert_array_equal(a, b.reshape(a.shape))
    # one full coalesced batch a pool step, one model version, nothing failed
    assert gated["mean_batch_occupancy"] == EPISODES and gated["batches"] == len(gated_steps)
    assert gated["versions_served"] == [8] and gated["failed_requests"] == 0


def test_a_registry_ref_serves_the_best_record(runs, tmp_path):
    reg = str(tmp_path / "reg")
    scored = service.evaluate_checkpoint(runs["dreamer_v2"], episodes=2, seed0=5, write_registry=True,
                                         registry_dir=reg, device="cpu")
    gw = ServeGateway.from_checkpoint(f"registry:best:{scored['algo']}:{scored['env']}", registry_dir=reg,
                                      device="cpu")
    try:
        status = gw.status()
        assert status["checkpoint"] == os.path.abspath(runs["dreamer_v2"]) and status["model_version"] == 8
        action, version = gw.client().act(_row(np.random.default_rng(0), gw))
        assert version == 8 and action.shape == (1,) and int(action[0]) in (0, 1)
    finally:
        gw.close()


def _publish_perturbed(runs, root, version):
    """The trainer's side of the channel: the checkpoint's modules, the
    actor's weights moved, as version ``version``."""
    agent = read_checkpoint(runs["dreamer_v3"], with_rb=False)["agent"]
    actor = {k: v + 0.5 if v.dtype.kind == "f" else v for k, v in agent["actor"].items()}
    publisher = PolicyPublisher(str(root), algo="dreamer_v3")
    publisher.publish(version, {"agent": {"world_model": agent["world_model"], "actor": actor}})
    return publisher


def test_hot_swap_under_load_from_a_publication_channel(runs, gateway, tmp_path):
    base = gateway.status()["model_version"]
    _publish_perturbed(runs, tmp_path / "pol", base + 1000)
    # a poll interval of an hour: poll_once below is the only poll, so the swap's place in the stream is known
    swapper = gateway.watch(str(tmp_path / "pol"), poll_interval_s=3600.0)
    client = gateway.client("loadgen")
    rng = np.random.default_rng(1)
    versions, errors = [], []
    for _ in range(3):
        versions.append(client.act(_row(rng, gateway))[1])
    assert versions == [base] * 3

    def hammer():
        try:
            for _ in range(20):
                versions.append(client.act(_row(rng, gateway))[1])
        except Exception as exc:  # noqa: BLE001 - checked below
            errors.append(exc)

    t = threading.Thread(target=hammer)
    t.start()
    assert swapper.poll_once() is True
    t.join(timeout=60)
    for _ in range(3):
        versions.append(client.act(_row(rng, gateway))[1])
    stats = gateway.status()
    assert not errors and stats["failed_requests"] == 0
    assert versions == sorted(versions) and versions[-1] == base + 1000
    assert stats["versions_served"] == [base, base + 1000] and stats["swaps"] == swapper.swaps == 1
    assert set(stats["versions"]) == {str(base), str(base + 1000)}
    assert swapper.poll_once() is False  # the same version never swaps again


def test_a_torn_publication_keeps_the_old_model_serving(runs, gateway, tmp_path):
    base = gateway.status()["model_version"]
    _publish_perturbed(runs, tmp_path / "pol", base + 5)
    with open(os.path.join(policy_path(str(tmp_path / "pol"), base + 5), "state.npz"), "r+b") as f:
        f.seek(64)
        f.write(b"\xff" * 16)  # a flipped run of bytes: the checksums fail
    os.makedirs(policy_path(str(tmp_path / "pol"), base + 9) + ".tmp")  # a partial write is never a version
    swapper = gateway.watch(str(tmp_path / "pol"), poll_interval_s=3600.0)
    with pytest.warns(UserWarning, match="refused"):
        assert swapper.poll_once() is False
    assert swapper.refused == {base + 5} and swapper.swaps == 0
    _action, version = gateway.client().act(_row(np.random.default_rng(2), gateway))
    assert version == base and gateway.status()["swaps"] == 0


def test_drain_finishes_in_flight_requests_and_refuses_later_ones(gateway):
    rng = np.random.default_rng(3)
    tickets = [gateway.batcher.submit(f"c{i}", _row(rng, gateway)) for i in range(6)]
    assert gateway.drain(timeout=30.0) is True
    for ticket in tickets:
        action, _version = gateway.batcher.wait(ticket, timeout=1.0)
        assert action is not None
    with pytest.raises(ServeClosed):
        gateway.client().act(_row(rng, gateway))
    assert gateway.status()["failed_requests"] == 0 and gateway.status()["requests"] == 6


class _BlockingModel:
    """A model whose act waits on an event: the drain times out on it."""

    version, device = 3, torch.device("cpu")

    def __init__(self):
        self.release = threading.Event()
        self.entered = threading.Event()

    def init_state_rows(self, n):
        return None

    def act(self, obs, state, generator):
        self.entered.set()
        self.release.wait(30.0)
        return np.zeros((len(obs["x"]), 1)), None


def test_a_drain_that_times_out_fails_the_queued_requests_loudly():
    model = _BlockingModel()
    batcher = RequestBatcher(model, max_batch=1, deadline_s=0.0)
    first = batcher.submit("a", {"x": np.zeros(1)})
    assert model.entered.wait(10.0)
    queued = batcher.submit("b", {"x": np.zeros(1)})
    threading.Timer(0.5, model.release.set).start()
    assert batcher.drain(timeout=0.1) is False
    assert batcher.wait(first, timeout=5.0)[1] == 3  # the batch in flight finished
    with pytest.raises(Exception, match="stopped before this request dispatched"):
        batcher.wait(queued, timeout=1.0)
    assert batcher.stats()["failed_requests"] == 1


def test_the_ring_serves_spawned_clients(gateway, tmp_path):
    import json

    ring = gateway.start_ring(3)
    spec = {"requests": 6, "seed": 4, "episode_len": 4, "out_dir": str(tmp_path / "clients")}
    procs = spawn_clients(ring, 2, "sheeprl_tpu_torch.serve.loadgen:seeded_client", spec)
    for p in procs:
        p.join(timeout=120)
        assert p.exitcode == 0
    for slot in range(2):
        with open(tmp_path / "clients" / f"client_{slot}.json") as f:
            seen = json.load(f)
        assert seen["errors"] == [] and seen["versions"] == [8] * 6 and not seen["torch_loaded"]
    stats = gateway.status()
    assert stats["requests"] == 12 and stats["failed_requests"] == 0


def test_a_ring_of_another_layout_refuses_to_unpickle():
    ring = ActSlabRing({"x": ((2,), np.float32)}, (1,), np.int64, 1)
    ring._obs_views()
    state = ring.__getstate__()
    assert state["_views"] is None and state["_act_view"] is None  # numpy views are rebuilt on the other side
    state["_layout"] = 99
    clone = ActSlabRing.__new__(ActSlabRing)
    with pytest.raises(RuntimeError, match="layout mismatch"):
        clone.__setstate__(state)
    ring.close()


def test_the_serve_command_serves_spawned_clients_and_drains(runs, tmp_path, monkeypatch):
    import json
    import signal

    monkeypatch.chdir(tmp_path)
    handlers = signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)
    out = tmp_path / "clients"
    final = cli.serve([
        f"checkpoint_path={runs['dreamer_v2']}", "fabric.accelerator=cpu", "serve.duration_s=4",
        "serve.max_clients=2", "serve.clients.n=2", "serve.clients.entry=sheeprl_tpu_torch.serve.loadgen:seeded_client",
        "serve.clients.spec.requests=5", f"serve.clients.spec.out_dir={out}",
    ])
    assert final["drained"] is True and final["failed_requests"] == 0 and final["requests"] == 10
    assert final["device"] == "cpu" and final["kernel_launches"]["hafner_cell"] == 0  # the CPU runs the plain cell
    assert (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)) == handlers  # the caller's are back
    for slot in range(2):
        with open(out / f"client_{slot}.json") as f:
            assert json.load(f)["versions"] == [8] * 5


OPS_KNOBS = ["serve.trace_sample_rate=0.1", "serve.access_log_sample_rate=0.5", "serve.metrics_port=0",
             "serve.slo.enabled=true", "serve.inject_dispatch_delay_s=0.01"]


@pytest.mark.parametrize("knob", OPS_KNOBS)
def test_the_ops_knobs_raise(runs, gateway, knob):
    from sheeprl_tpu_torch.config import compose

    settings = serve_settings(compose("serve_config", overrides=["checkpoint_path=x", knob]))
    with pytest.raises(NotImplementedError, match="6g/6h"):
        gateway.enable_ops(settings)
    with pytest.raises(NotImplementedError, match="6g/6h"):
        cli.serve([f"checkpoint_path={runs['dreamer_v2']}", "fabric.accelerator=cpu", "serve.duration_s=1", knob])


def test_no_ops_knob_means_no_ops_surface(gateway):
    assert gateway.enable_ops(serve_settings(dotdict({}))) is None
    gateway.batcher.attach_ops(None)
    with pytest.raises(NotImplementedError, match="6g/6h"):
        gateway.batcher.attach_ops(object())


@pytest.mark.parametrize("group", [{}, {"serve": {"max_batch": 16}}, {"serve": None}])
def test_serve_settings_fill_the_shipped_defaults(group):
    from sheeprl_tpu_torch.config import compose

    ours, theirs = serve_settings(dotdict(group)), jax_serve_settings(jax_dotdict(group))
    # the port's one extra knob: the load clients its serve command spawns
    assert ours.pop("clients") == {"n": 0, "entry": None, "spec": {}}
    assert dict(ours) == dict(theirs)
    shipped = compose("serve_config", overrides=["checkpoint_path=x"]).serve
    for key, value in serve_settings(dotdict({})).items():
        if key not in ("slo", "clients"):
            assert shipped[key] == value, key

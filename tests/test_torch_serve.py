"""The port's serving path on the CPU: ServeGateway → RequestBatcher →
GatewayModel → the DreamerV2 player step, at a small width."""

import threading

import gymnasium as gym
import numpy as np
import pytest
import torch

from sheeprl_tpu.evals.builders import actions_dim_of as jax_actions_dim_of
from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_agent
from sheeprl_tpu_torch.configs import dreamer_v2_config
from sheeprl_tpu_torch.evals.builders import actions_dim_of
from sheeprl_tpu_torch.serve import GatewayModel, ServeClosed, ServeGateway, ServeRequestError

SMALL = {
    "algo.dense_units": 16,
    "algo.mlp_layers": 2,
    "algo.world_model.encoder.cnn_channels_multiplier": 2,
    "algo.world_model.recurrent_model.recurrent_state_size": 16,
    "algo.world_model.stochastic_size": 4,
    "algo.world_model.discrete_size": 4,
    "algo.world_model.transition_model.hidden_size": 12,
    "algo.world_model.representation_model.hidden_size": 12,
}
OBS = {"rgb": (3, 64, 64)}


@pytest.fixture(scope="module")
def model():
    cfg = dreamer_v2_config(**SMALL)
    wm, actor = build_agent(cfg, (9,), False, OBS, seed=1, device="cpu")
    params = {"world_model": wm.state_dict(), "actor": actor.state_dict()}
    return GatewayModel.from_params(params, cfg, OBS, (9,), False, device="cpu", version=7)


def _frame(rng):
    return {"rgb": rng.randint(0, 256, (3, 64, 64)).astype(np.uint8)}


def test_clients_carry_their_own_state_across_requests(model):
    gateway = ServeGateway(model, max_batch=4, deadline_s=0.02, seed=3)
    try:
        clients = [gateway.client(f"c{i}") for i in range(3)]
        rng = np.random.RandomState(0)
        prev = {}
        for step in range(3):
            for c in clients:
                action, version = c.act(_frame(rng), reset=step == 0)
                assert version == 7 and action.shape == (1,) and 0 <= int(action[0]) < 9
                rec = gateway.batcher.state_of(c.client_id)["recurrent"].clone()
                if c.client_id in prev:
                    assert not torch.equal(rec, prev[c.client_id])
                prev[c.client_id] = rec
        assert len({c.client_id for c in clients} & set(gateway.batcher._states)) == 3
        status = gateway.status()
        assert status["requests"] == 9 and status["failed_requests"] == 0
    finally:
        gateway.close()


def test_reset_starts_the_client_from_a_fresh_state(model):
    rng = np.random.RandomState(1)
    frames = [_frame(rng) for _ in range(2)]
    results = []
    for history in ([frames[0]], []):  # one client with a past, one without
        gateway = ServeGateway(model, max_batch=1, deadline_s=0.0, seed=5)
        try:
            c = gateway.client("c")
            for f in history:
                c.act(f)
            gateway.batcher._generator = torch.Generator().manual_seed(9)  # same noise for the reset step
            c.act(frames[1], reset=True)
            results.append(gateway.batcher.state_of("c")["recurrent"].clone())
        finally:
            gateway.close()
    torch.testing.assert_close(results[0], results[1], rtol=0, atol=0)


def test_batched_dispatch_equals_model_act_on_stacked_rows(model):
    n, seed = 4, 13
    rng = np.random.RandomState(2)
    frames = [_frame(rng) for _ in range(n)]
    gateway = ServeGateway(model, max_batch=n, deadline_s=5.0, seed=seed)
    try:
        tickets = [gateway.batcher.submit(f"c{i}", f, reset=True) for i, f in enumerate(frames)]
        served = np.stack([gateway.batcher.wait(t, timeout=60.0)[0] for t in tickets])
        assert gateway.status()["batches"] == 1
        states = [gateway.batcher.state_of(f"c{i}")["recurrent"] for i in range(n)]
    finally:
        gateway.close()
    obs = {"rgb": np.stack([f["rgb"] for f in frames])}
    direct, direct_state = model.act(obs, model.init_state_rows(n), torch.Generator().manual_seed(seed))
    np.testing.assert_array_equal(served, direct)
    torch.testing.assert_close(torch.cat(states), direct_state["recurrent"], rtol=0, atol=0)


def test_drain_finishes_queued_work_then_refuses(model):
    gateway = ServeGateway(model, max_batch=8, deadline_s=0.5, seed=0)
    rng = np.random.RandomState(3)
    tickets = [gateway.batcher.submit(f"c{i}", _frame(rng)) for i in range(3)]
    assert gateway.drain(timeout=30.0)
    for t in tickets:
        action, _ = gateway.batcher.wait(t, timeout=1.0)
        assert 0 <= int(action[0]) < 9
    with pytest.raises(ServeClosed):
        gateway.client("late").act(_frame(rng))


class _FlakyModel:
    """Fails its first dispatch, then answers zeros."""

    version, algo, env_id, device = 1, "fake", "fake", torch.device("cpu")

    def __init__(self):
        self.calls = 0
        self.lock = threading.Lock()

    def init_state_rows(self, n):
        return None

    def act(self, obs, state, generator):
        with self.lock:
            self.calls += 1
            first = self.calls == 1
        if first:
            raise RuntimeError("boom")
        return np.zeros((len(obs["x"]), 1), np.int64), None


def test_a_failing_batch_fails_only_its_requests():
    gateway = ServeGateway(_FlakyModel(), max_batch=2, deadline_s=5.0)
    try:
        tickets = [gateway.batcher.submit(f"c{i}", {"x": np.zeros(2)}) for i in range(4)]
        with pytest.raises(ServeRequestError, match="boom"):
            gateway.batcher.wait(tickets[0], timeout=30.0)
        with pytest.raises(ServeRequestError):
            gateway.batcher.wait(tickets[1], timeout=30.0)
        for t in tickets[2:]:
            assert gateway.batcher.wait(t, timeout=30.0)[0].tolist() == [0]
        assert gateway.status()["failed_requests"] == 2
    finally:
        gateway.close()


def test_swap_stamps_the_new_version(model):
    gateway = ServeGateway(model, max_batch=1, deadline_s=0.0)
    try:
        rng = np.random.RandomState(4)
        assert gateway.client("c").act(_frame(rng))[1] == 7
        other = GatewayModel(model.policy, version=8, algo="dreamer_v2", env_id="x", device="cpu")
        assert gateway.batcher.swap(other) == 8
        assert gateway.client("c").act(_frame(rng))[1] == 8
        assert gateway.status()["versions_served"] == [7, 8]
    finally:
        gateway.close()


@pytest.mark.parametrize(
    "space",
    [gym.spaces.Discrete(9), gym.spaces.MultiDiscrete([3, 4]), gym.spaces.Box(-1.0, 1.0, (6,), np.float32)],
    ids=["discrete", "multi_discrete", "box"],
)
def test_actions_dim_of_matches_jax(space):
    dims, continuous = jax_actions_dim_of(space)
    assert actions_dim_of(space) == (tuple(int(d) for d in dims), continuous)

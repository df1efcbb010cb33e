"""The port's sharded and prioritized replay (``sheeprl_tpu_torch/replay``)
against the JAX package's, on the CPU.

The port's buffers sample with the JAX package's numpy formulas and draw
order, so the same adds and the same seed must give the same plans, the
same importance weights and the same priority tables: every comparison
here is exact (``np.array_equal``) but SAC's TD residuals, which come from
a float32 step in each framework (atol 1e-5, the losses' rtol 1e-4).

Also: the factory's objects, the replay plane's ingest, the staging's
writeback, the coupled SAC run with ``replay.strategy=td_priority``.
"""

from __future__ import annotations

import itertools

import jax
import numpy as np
import pytest
import torch

from sheeprl_tpu.data.buffers import ReplayBuffer as JaxReplayBuffer
from sheeprl_tpu.replay import ShardedReplay as JaxShardedReplay
from sheeprl_tpu.replay import apportion_by_fill as jax_apportion
from sheeprl_tpu.replay import make_strategy as jax_make_strategy
from sheeprl_tpu.replay import shard_env_split as jax_shard_env_split
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.data.buffers import ReplayBuffer
from sheeprl_tpu_torch.replay import (
    ReplayPlane,
    ShardedReplay,
    TDPriorityStrategy,
    apportion_by_fill,
    make_replay_buffer,
    make_strategy,
    shard_env_split,
)


@pytest.fixture(autouse=True, scope="module")
def restore_prng_impl():
    """The JAX Fabric (the TD test's) switches JAX's default key
    implementation for the whole process: put it back after the module."""
    saved = jax.config.jax_default_prng_impl
    yield
    jax.config.update("jax_default_prng_impl", saved)


PRIORITY = {"alpha": 0.7, "beta": 0.5, "eps": 1e-6}


def _rows(steps, n_envs, code, seed):
    rng = np.random.RandomState(seed)
    return {
        "observations": (code * 1000 + rng.randn(steps, n_envs, 3)).astype(np.float32),
        "actions": rng.randn(steps, n_envs, 2).astype(np.float32),
        "rewards": rng.randn(steps, n_envs, 1).astype(np.float32),
        "dones": (rng.uniform(size=(steps, n_envs, 1)) < 0.1).astype(np.float32),
    }


def _pair(size=16, n_envs=3, adds=((5, 0), (9, 1), (6, 2)), seed=11):
    """A port and a JAX buffer given the same adds (the last wraps the ring)."""
    port, jax_rb = ReplayBuffer(size, n_envs), JaxReplayBuffer(size, n_envs)
    for steps, code in adds:
        rows = _rows(steps, n_envs, code, code)
        port.add(rows)
        jax_rb.add(rows)
    port.seed(seed)
    jax_rb.seed(seed)
    return port, jax_rb


def _table(strategy, rb):
    return strategy._state[id(rb)][1], strategy._state[id(rb)][2]


@pytest.mark.parametrize("name,sample_next_obs", itertools.product(["uniform", "prioritize_ends", "td_priority"],
                                                                  [False, True]))
def test_the_strategies_plan_weight_and_score_as_jax_s(name, sample_next_obs):
    cfg = {"strategy": name, "priority": PRIORITY}
    port_s, jax_s = make_strategy(cfg), jax_make_strategy(cfg)
    assert type(port_s).__name__ == type(jax_s).__name__ and port_s.needs_writeback == jax_s.needs_writeback
    port, jax_rb = _pair()
    rng = np.random.RandomState(3)
    for burst in range(4):
        envs = None if burst % 2 == 0 else [0, 2]
        got = port_s.plan(port, 7, sample_next_obs=sample_next_obs, n_samples=2, envs=envs)
        want = jax_s.plan(jax_rb, 7, sample_next_obs=sample_next_obs, n_samples=2, envs=envs)
        for g, w in zip(got, want):
            assert np.array_equal(g, w), (burst, g, w)
        for normalize in (True, False):
            gw, ww = port_s.weights(port, normalize), jax_s.weights(jax_rb, normalize)
            assert (gw is None) == (ww is None) and (gw is None or np.array_equal(gw, ww))
        td = rng.randn(len(got[0])).astype(np.float32)
        port_s.update_priorities(port, got[0], got[1], td)
        jax_s.update_priorities(jax_rb, want[0], want[1], td)
        port_s.init_priorities(port, np.array([burst, 15]))
        jax_s.init_priorities(jax_rb, np.array([burst, 15]))
        if name == "td_priority":
            (gt, gm), (wt, wm) = _table(port_s, port), _table(jax_s, jax_rb)
            assert np.array_equal(gt, wt) and gm == wm and (gt > 0).any()
    gathered = port.gather_plan(*got, sample_next_obs=sample_next_obs)
    want_rows = jax_rb.gather_plan(*want, sample_next_obs=sample_next_obs)
    assert sorted(gathered) == sorted(want_rows)
    for k in gathered:
        assert np.array_equal(gathered[k], want_rows[k]), k


def test_the_strategies_check_their_inputs():
    port, _ = _pair()
    for bad in ({"alpha": -1.0}, {"beta": -1.0}, {"eps": 0.0}):
        with pytest.raises(ValueError):
            TDPriorityStrategy(**bad)
    with pytest.raises(ValueError, match="must be one of"):
        make_strategy({"strategy": "bogus"})
    with pytest.raises(ValueError, match="No sample"):
        make_strategy({"strategy": "td_priority"}).plan(ReplayBuffer(4, 1), 2)
    with pytest.raises(ValueError, match="shapes disagree"):
        TDPriorityStrategy().update_priorities(port, np.arange(3), np.arange(2), np.ones(3))


def test_apportionment_and_the_env_split_are_jax_s():
    for total, weights in itertools.product((0, 1, 5, 7, 32, 97),
                                            ([1.0, 1.0], [3.0, 1.0], [0.0, 2.0], [1.0, 1.0, 1.0],
                                             [0.3, 11.0, 2.5, 0.0])):
        assert apportion_by_fill(total, weights) == jax_apportion(total, weights)
    for n_envs, shards in itertools.product(range(1, 9), range(1, 5)):
        if shards <= n_envs:
            assert shard_env_split(n_envs, shards) == jax_shard_env_split(n_envs, shards)
    with pytest.raises(ValueError, match="No shard holds data"):
        apportion_by_fill(4, [0.0, 0.0])
    with pytest.raises(ValueError, match="cannot exceed"):
        shard_env_split(2, 3)


@pytest.mark.parametrize("strategy", ["uniform", "prioritize_ends", "td_priority"])
def test_the_sharded_replay_samples_and_writes_back_as_jax_s(strategy):
    cfg = {"strategy": strategy, "priority": PRIORITY}
    port = ShardedReplay([ReplayBuffer(16, 2), ReplayBuffer(16, 1)], strategy=make_strategy(cfg))
    jax_rb = JaxShardedReplay([JaxReplayBuffer(16, 2), JaxReplayBuffer(16, 1)], strategy=jax_make_strategy(cfg))
    for steps, code in ((6, 0), (13, 1)):
        rows = _rows(steps, 3, code, code)
        port.add(rows)
        jax_rb.add(rows)
    extra = _rows(4, 1, 5, 5)
    port.add_shard(1, extra)
    jax_rb.add_shard(1, extra)
    port.init_priorities_newest(1, 4)
    jax_rb.init_priorities_newest(1, 4)
    port.seed(7)
    jax_rb.seed(7)
    rng = np.random.RandomState(0)
    for _ in range(3):
        got = port.sample(5, n_samples=2, sample_next_obs=True)
        want = jax_rb.sample(5, n_samples=2, sample_next_obs=True)
        assert sorted(got) == sorted(want)
        for k in got:
            assert np.array_equal(got[k], want[k]), k
        gw, ww = port.last_weights(), jax_rb.last_weights()
        assert (gw is None) == (ww is None) and (gw is None or np.array_equal(gw, ww))
        td = rng.randn(10)
        port.update_priorities(td)
        jax_rb.update_priorities(td)
    if strategy == "td_priority":
        for p in range(2):
            (gt, gm), (wt, wm) = _table(port.strategy, port.shards[p]), _table(jax_rb.strategy, jax_rb.shards[p])
            assert np.array_equal(gt, wt) and gm == wm
    state = port.state_dict()
    restored = ShardedReplay([ReplayBuffer(16, 2), ReplayBuffer(16, 1)])
    restored.load_state_dict(state)
    assert np.array_equal(restored.shards[1]["observations"], port.shards[1]["observations"])
    with pytest.raises(ValueError, match="replay.shards must match"):
        ShardedReplay([ReplayBuffer(16, 3)]).load_state_dict(state)


def test_the_factory_builds_what_the_config_names(tmp_path):
    from sheeprl_tpu_torch.fabric import Fabric

    fabric = Fabric(accelerator="cpu")

    def build(*overrides, **kwargs):
        cfg = compose(overrides=["exp=sac", "buffer.size=64", "buffer.memmap=False", *overrides])
        return make_replay_buffer(cfg, fabric, str(tmp_path), n_envs=4, **kwargs)

    assert type(build()) is ReplayBuffer
    one = build("replay.strategy=prioritize_ends")
    assert isinstance(one, ShardedReplay) and one.n_shards == 1 and one.n_envs == 4
    two = build("replay.shards=2", "replay.strategy=td_priority")
    assert two.n_shards == 2 and [s.n_envs for s in two.shards] == [2, 2] and two.needs_writeback
    assert type(build("replay.shards=2", size=8, sampled=False)) is ReplayBuffer  # rollout storage
    with pytest.warns(UserWarning, match="only applies to transition replay"):
        build("replay.strategy=td_priority", kind="sequential")
    with pytest.raises(ValueError, match="only supported for sampled transition"):
        build("replay.shards=2", kind="sequential")


class _Handle:
    def __init__(self, data, ep_stats):
        self.data, self.ep_stats, self.released = data, ep_stats, False

    def release(self):
        self.released = True


class _Plane:
    n_players = 2


def test_the_replay_plane_lands_each_players_slab_in_its_shard():
    sharded = ShardedReplay([ReplayBuffer(8, 1), ReplayBuffer(8, 1)], strategy=TDPriorityStrategy())
    plane = ReplayPlane(_Plane(), sharded)
    handles = [_Handle(_rows(4, 1, p, p), [(float(p), 1.0)]) for p in range(2)]
    assert plane.ingest(handles, 3) == [(0.0, 1.0), (1.0, 1.0)]
    assert all(h.released for h in handles)
    for p in range(2):
        np.testing.assert_array_equal(sharded.shards[p]["observations"][:3], handles[p].data["observations"][:3])
        table, top = _table(sharded.strategy, sharded.shards[p])
        assert (table[:3] == top).all() and (table[3:] == 0).all()
    with pytest.raises(ValueError, match="must equal plane.num_players"):
        ReplayPlane(_Plane(), ShardedReplay([ReplayBuffer(8, 1)]))


def test_the_staging_writes_priorities_back_and_gives_the_weights():
    from sheeprl_tpu_torch.data.staging import make_replay_staging
    from sheeprl_tpu_torch.fabric import Fabric

    cfg = compose(overrides=["exp=sac", "replay.strategy=td_priority", "buffer.prefetch=True"])
    rb = ShardedReplay([ReplayBuffer(16, 2)], strategy=TDPriorityStrategy())
    rb.add(_rows(10, 2, 0, 0))
    with pytest.warns(UserWarning, match="prefetch=True is disabled"):
        staging = make_replay_staging(cfg, Fabric(accelerator="cpu"), rb, seed=3)
    try:
        batch = staging.sample_device(4, n_samples=2)
        assert batch["observations"].shape == (2, 4, 3) and staging._pool is None
        w = staging.last_weights()
        assert w.shape == (8,) and w.max() == 1.0
        staging.update_priorities(np.arange(8.0))
        table, top = _table(rb.strategy, rb.shards[0])
        assert top == 7.0 + 1e-6 and (table > 0).sum() >= 1
    finally:
        staging.close()


def test_sac_td_residuals_match_jax():
    """``build_train_fn(emit_td=True)``'s per-row ``min_i Q_i(s, a) − y``
    of the critics before their update, both packages, at the same weights,
    batch and noise (a two-step burst: the second step's residuals read the
    first step's update). atol 1e-5."""
    import jax.numpy as jnp
    from test_torch_sac import ACT, HIDDEN, LOW, HIGH, SMALL, jax_fabric, jax_state, sac_noise, torch_state, \
        transition_batch

    from sheeprl_tpu.algos.sac import agent as jax_agent
    from sheeprl_tpu.algos.sac import sac as jax_sac
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.config.instantiate import instantiate as jax_instantiate
    from sheeprl_tpu_torch.algos.sac import sac
    from sheeprl_tpu_torch.algos.sac.agent import action_bounds
    from sheeprl_tpu_torch.envs import spaces

    fabric = jax_fabric()
    _actor, _critic, params = jax_state()
    batch = transition_batch(5, g=2)
    key = jax.random.PRNGKey(13)
    jcfg = jax_compose(overrides=["exp=sac"] + SMALL)
    actor = jax_agent.SACActor(action_dim=ACT, hidden_size=HIDDEN)
    critic = jax_agent.SACCritic(hidden_size=HIDDEN, num_critics=1)
    txs = {k: jax_instantiate(jcfg.algo[n].optimizer) for k, n in (("actor", "actor"), ("qf", "critic"),
                                                                   ("alpha", "alpha"))}
    opts = {"actor": txs["actor"].init(params["actor"]), "qf": txs["qf"].init(params["critics"]),
            "alpha": txs["alpha"].init(params["log_alpha"])}
    scale, bias = action_bounds(spaces.Box(LOW, HIGH))
    train = jax_sac.build_train_fn(actor, critic, txs["actor"], txs["qf"], txs["alpha"], jcfg, fabric, scale, bias,
                                   -float(ACT), donate=False, emit_td=True)
    outs = train(jax.tree_util.tree_map(jnp.asarray, params), opts, {k: jnp.asarray(v) for k, v in batch.items()},
                 key, jnp.bool_(True))
    want_td = np.asarray(outs[-1])
    cfg = compose(overrides=["exp=sac"] + SMALL)
    state = torch_state(cfg, params)
    program = sac.build_train_fn(cfg, ACT, -float(ACT), emit_td=True)
    program.burst(state, {k: torch.from_numpy(v) for k, v in batch.items()}, sac.ema_gates(True, float(cfg.algo.tau)),
                  noise=sac_noise(key, 2))
    assert want_td.shape == program.last_td.shape == (2, 8, 1)
    np.testing.assert_allclose(program.last_td.numpy(), want_td, rtol=0, atol=1e-5)


def test_coupled_sac_writes_td_priorities_back(tmp_path, monkeypatch):
    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.replay import strategies

    calls = []
    update = strategies.TDPriorityStrategy.update_priorities

    def counted(self, rb, t_idx, e_idx, td):
        calls.append(len(td))
        return update(self, rb, t_idx, e_idx, td)

    monkeypatch.setattr(strategies.TDPriorityStrategy, "update_priorities", counted)
    monkeypatch.chdir(tmp_path)
    with pytest.warns(UserWarning, match="prefetch=True is disabled"):
        result = cli.run(["exp=sac", "env.id=Pendulum-v1", "env.num_envs=2", "env.sync_env=True", "env.capture_video=False",
                          "fabric.accelerator=cpu", "replay.shards=2", "replay.strategy=td_priority", "total_steps=48",
                          "algo.learning_starts=16", "algo.hidden_size=8", "per_rank_batch_size=4",
                          "buffer.memmap=False", "buffer.size=64", "algo.run_test=False", "metric.log_level=0",
                          f"root_dir={tmp_path}/logs", "run_name=td"])
    assert result["train_bursts"] == 17 and result["gradient_steps"] == 24
    # one writeback a burst, each shard's share of its rows: 4 rows a gradient step in all
    assert sum(calls) == 4 * result["gradient_steps"] and len(calls) == 2 * result["train_bursts"]

"""The decoupled entrypoints (``sac_decoupled``, ``ppo_decoupled``) through
the port's CLI on the CPU.

- the CLI's device and strategy rules, as the JAX package's
  (``sheeprl_tpu/cli.py``): ``fabric.devices=1`` refuses a decoupled
  entrypoint, ``auto`` runs it (one learner device, the players on the CPU),
  ``fabric.devices=2`` raises naming item 7; ``plane.num_players>0`` refuses
  a sync env pool; ``strategy=ddp`` over one device trains;
- the regression gate: a seeded 1-player process run is bitwise the thread
  run (final learner state, optimizers, counters and, for SAC, the replay),
  for SAC and for PPO;
- the decoupled PPO update on a slab split over two players equals the
  coupled loop's update of the same rollout;
- a 2-player SAC run with two replay shards and TD priorities; the
  evaluation and the gateway on a decoupled checkpoint;
- ``chip_smoke.pendulum_stand_in`` (the card's Pendulum-v1) against
  gymnasium's: observations within 1e-6, rewards within 1e-5.

No JAX ``Fabric`` is built here.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.ckpt import read_checkpoint


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


COMMON = ["fabric.devices=auto", "fabric.accelerator=cpu", "env.capture_video=False", "metric.log_level=0",
          "buffer.memmap=False", "algo.run_test=False", "checkpoint.every=1000000", "checkpoint.save_last=True",
          "env.vectorization=async"]
SAC = ["exp=sac_decoupled", "env.id=Pendulum-v1", "env.num_envs=2", "buffer.size=1024", "buffer.prefetch=False",
       "buffer.checkpoint=True", "per_rank_batch_size=8", "total_steps=160", "algo.learning_starts=48",
       "algo.hidden_size=8"] + COMMON
PPO = ["exp=ppo_decoupled", "env.id=CartPole-v1", "env.num_envs=2", "algo.rollout_steps=16", "per_rank_batch_size=8",
       "total_steps=128", "algo.update_epochs=2", "algo.anneal_lr=True"] + COMMON


def _run(tmp_path, args, name):
    return cli.run(args + [f"root_dir={tmp_path}/{name}", f"run_name={name}"])


@pytest.mark.parametrize(
    "extra,error,match",
    [
        (["fabric.devices=1"], RuntimeError, "requires at least 2 devices"),
        (["fabric.devices=2"], NotImplementedError, "item 7"),
        (["plane.num_players=2", "env.vectorization=sync"], RuntimeError, "sync env pool"),
        (["plane.num_players=2", "env.vectorization=null", "env.sync_env=True"], RuntimeError, "sync env pool"),
        (["plane.keep_policies=1", "plane.num_players=1"], RuntimeError, "keep_policies"),
        (["plane.num_players=3"], ValueError, "must divide"),
        (["replay.shards=2"], ValueError, "requires plane.num_players=2"),
        (["replay.adopt_slabs=True"], NotImplementedError, "item 6j"),
        (["fabric.strategy=fsdp"], NotImplementedError, "item 7"),
    ],
)
def test_the_cli_rules_for_the_decoupled_entrypoints(tmp_path, monkeypatch, extra, error, match):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(error, match=match):
        _run(tmp_path, SAC + ["dry_run=True"] + extra, "rules")


def test_a_one_device_ddp_fabric_trains_as_auto():
    from sheeprl_tpu_torch.fabric import Fabric

    for strategy in ("ddp", "dp", "auto"):
        fabric = Fabric(accelerator="cpu", strategy=strategy, devices="auto")
        assert (fabric.world_size, fabric.device) == (1, torch.device("cpu"))


@pytest.mark.parametrize("base", [SAC, PPO], ids=["sac_decoupled", "ppo_decoupled"])
def test_a_one_player_process_run_is_bitwise_the_thread_run(tmp_path, monkeypatch, base):
    monkeypatch.chdir(tmp_path)
    thread = _run(tmp_path, base + ["plane.num_players=0"], "thread")
    process = _run(tmp_path, base + ["plane.num_players=1"], "process")
    assert thread["plane"]["players"] == 0 and process["plane"]["players"] == 1
    assert process["plane"]["exits"] == {0: {"cuda_initialized": False}}
    assert thread["episode_returns"] == process["episode_returns"]
    a, b = (dict(_leaves(read_checkpoint(r["checkpoint"]))) for r in (thread, process))
    assert sorted(a) == sorted(b) and len(a) > 20
    rows = thread["updates"]  # the replay's written rows (SAC); PPO's checkpoint holds no buffer
    for k in a:
        got, want = (x[:rows] if k.startswith("/rb/buffer/") else x for x in (b[k], a[k]))
        assert np.array_equal(got, want), k


def test_a_decoupled_ppo_update_on_the_players_slabs_is_the_coupled_update():
    """A rollout of 4 envs split over two players' slabs: its GAE and update
    data equal the coupled loop's (its rollout buffer, ``GaeStep``,
    ``PPO.update_data``), and so does the update at the same permutations."""
    from sheeprl_tpu_torch.algos.ppo.agent import build_agent
    from sheeprl_tpu_torch.algos.ppo.ppo import PPO, GaeStep, build_optimizer
    from sheeprl_tpu_torch.algos.ppo.ppo_decoupled import assemble_rollout, rollout_update_data
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.data.buffers import ReplayBuffer
    from sheeprl_tpu_torch.envs import spaces

    T, n = 8, 4
    cfg = compose(overrides=["exp=ppo", f"algo.rollout_steps={T}", f"env.num_envs={n}", "per_rank_batch_size=8",
                             "algo.update_epochs=2"])
    rng = np.random.RandomState(0)
    rollout = {"state": rng.randn(T, n, 4).astype(np.float32),
               "dones": (rng.uniform(size=(T, n, 1)) < 0.2).astype(np.float32),
               "values": rng.randn(T, n, 1).astype(np.float32),
               "actions": np.eye(2, dtype=np.float32)[rng.randint(0, 2, (T, n))],
               "logprobs": -rng.uniform(size=(T, n, 1)).astype(np.float32),
               "rewards": rng.randn(T, n, 1).astype(np.float32)}
    next_values = rng.randn(1, n, 1).astype(np.float32)
    handles = [SimpleNamespace(data={**{k: v[:, 2 * p:2 * p + 2] for k, v in rollout.items()},
                                     "next_values": next_values[:, 2 * p:2 * p + 2]}) for p in range(2)]
    decoupled = rollout_update_data(assemble_rollout(handles), ["state"], GaeStep(0.99, 0.95, "cpu"))
    rb = ReplayBuffer(T, n, obs_keys=("state",))
    for t in range(T):
        rb.add({k: v[t:t + 1] for k, v in rollout.items()})
    returns, advantages = GaeStep(0.99, 0.95, "cpu")(rb["rewards"], rb["values"], rb["dones"],
                                                    torch.from_numpy(next_values[0]))
    family = SimpleNamespace(run=SimpleNamespace(obs_keys=["state"]), stored=("logprobs",))
    coupled = PPO.update_data(family, rb, returns, advantages)
    assert sorted(decoupled) == sorted(coupled)
    for k in coupled:
        assert np.array_equal(np.asarray(decoupled[k]), np.asarray(coupled[k])), k

    space = spaces.Dict({"state": spaces.Box(-np.inf, np.inf, (4,), np.float32)})
    run = SimpleNamespace(actions_dim=[2], is_continuous=False, cnn_keys=[], obs_keys=["state"], generator=None)
    perms = [np.random.RandomState(e).permutation(T * n) for e in range(2)]
    params = []
    for data in (decoupled, coupled):
        agent = build_agent(cfg, [2], False, [], ["state"], space, torch.Generator().manual_seed(1))
        program = PPO.make_program(cfg, agent, build_optimizer(cfg, agent), run, T * n, "cpu")
        program.update(data, [0.2, 0.0], perms=perms)
        params.append({k: v.detach().clone() for k, v in agent.state_dict().items()})
    for k in params[0]:
        assert torch.equal(params[0][k], params[1][k]), k


def test_two_players_with_two_shards_and_td_priorities(tmp_path, monkeypatch):
    from sheeprl_tpu_torch.replay import strategies

    calls = []
    update = strategies.TDPriorityStrategy.update_priorities
    monkeypatch.setattr(strategies.TDPriorityStrategy, "update_priorities",
                        lambda self, rb, t, e, td: (calls.append(len(td)), update(self, rb, t, e, td)))
    monkeypatch.chdir(tmp_path)
    with pytest.warns(UserWarning, match="prefetch=True is disabled"):
        result = _run(tmp_path, SAC + ["plane.num_players=2", "replay.shards=2", "replay.strategy=td_priority",
                                       "buffer.prefetch=True"], "sharded")
    assert result["plane"]["players"] == 2 and result["plane"]["slabs"] == 2 * result["updates"] == 160
    assert sum(calls) == 8 * result["gradient_steps"]
    state = read_checkpoint(result["checkpoint"])
    assert len(state["rb"]["shards"]) == 2
    for shard in state["rb"]["shards"]:
        assert shard["buffer"]["observations"].shape == (512, 1, 3)


def test_a_decoupled_checkpoint_is_evaluated_and_served(tmp_path, monkeypatch):
    from sheeprl_tpu_torch.evals.service import _builder_for
    from sheeprl_tpu_torch.serve.model import load_gateway_model

    monkeypatch.chdir(tmp_path)
    for base, algo in ((SAC, "sac_decoupled"), (PPO, "ppo_decoupled")):
        result = _run(tmp_path, base + ["dry_run=True", "env.vectorization=sync", "algo.run_test=True"], algo)
        assert result["test_steps"] == 1
        evaluation = cli.evaluation([f"checkpoint_path={result['checkpoint']}", "fabric.accelerator=cpu",
                                     "eval.episodes=2", f"eval.registry_dir={tmp_path}/registry"])
        assert evaluation["n"] == 2 and np.isfinite(evaluation["returns"]).all()
        model, cfg, observation_space, action_space = load_gateway_model(result["checkpoint"], device="cpu")
        obs = {k: np.random.RandomState(0).randn(3, *s.shape).astype(np.float32) for k, s in observation_space.items()}
        served = model.act(obs, None, torch.Generator())[0]
        state = read_checkpoint(result["checkpoint"], with_rb=False)
        policy = _builder_for(algo)(None, cfg, state, observation_space, action_space, device="cpu")
        assert np.array_equal(np.asarray(served), np.asarray(policy.act(obs, None, None)[0]))


def test_the_pendulum_stand_in_is_gymnasiums_pendulum():
    """``chip_smoke.pendulum_stand_in`` (the card's Pendulum-v1: the port's
    device Pendulum on the CPU in float64) against gymnasium's: the same
    seeded resets, observations within 1e-6, rewards within 1e-5, the
    200-step truncation, the spaces and the spec id."""
    import gymnasium as gym

    import chip_smoke

    stand_in, ref = chip_smoke.pendulum_stand_in("Pendulum-v1", render_mode="rgb_array"), gym.make("Pendulum-v1")
    assert stand_in.spec.id == ref.spec.id and stand_in.spec.max_episode_steps == ref.spec.max_episode_steps == 200
    assert stand_in.observation_space.shape == ref.observation_space.shape == (3,)
    np.testing.assert_array_equal(stand_in.action_space.low, ref.action_space.low)
    np.testing.assert_array_equal(stand_in.observation_space.high, ref.observation_space.high)
    rng = np.random.RandomState(0)
    for seed in (3, None, 11):
        a, _ = stand_in.reset(seed=seed)
        b, _ = ref.reset(seed=seed)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        for t in range(200):
            action = rng.uniform(-2.5, 2.5, (1,)).astype(np.float32)
            out_a, out_b = stand_in.step(action), ref.step(action)
            np.testing.assert_allclose(out_a[0], out_b[0], rtol=0, atol=1e-6)
            assert abs(out_a[1] - float(out_b[1])) <= 1e-5 and out_a[2] == out_b[2] == False  # noqa: E712
            assert out_a[3] == out_b[3] == (t == 199)
    with pytest.raises(ValueError, match="Pendulum-v1 only"):
        chip_smoke.pendulum_stand_in("CartPole-v1")

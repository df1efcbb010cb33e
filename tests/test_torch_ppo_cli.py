"""The port's PPO, A2C and PPO-recurrent runs through its CLI on the CPU, at
a tiny width: the dummy envs' pixels (discrete, multi-discrete and
continuous actions, as ``tests/test_algos/test_algos.py`` runs PPO) and
gymnasium's ``CartPole-v1`` vectors (PPO-recurrent with its preset's
velocity mask).

- A dry run does one update: ``rollout_steps`` acting steps, then
  ``update_epochs`` (A2C: one) passes of minibatch steps; its checkpoint
  holds the JAX tree's entries.
- A run checkpoints and resumes from its own checkpoint (the JAX loop's
  counters: the checkpointed update runs again), the ``evaluation`` command
  scores it, and the serving gateway's actions equal the evaluation
  policy's greedy actions on the same observations (PPO-recurrent's state
  kept per client by the batcher, reset at a client's first request).
- Resuming from the JAX package's checkpoints: ``tests/test_torch_ppo_jax_ckpt.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.ckpt import read_checkpoint, validate_checkpoint
from sheeprl_tpu_torch.evals.service import _builder_for, probe_spaces
from sheeprl_tpu_torch.serve import ServeGateway
from sheeprl_tpu_torch.serve.model import load_gateway_model

TINY = ["env.sync_env=True", "env.capture_video=False", "env.num_envs=2", "buffer.memmap=False", "metric.log_level=0",
        "algo.dense_units=8", "algo.encoder.mlp_features_dim=8", "algo.encoder.cnn_features_dim=8"]
PIXELS = ["env=dummy", "cnn_keys.encoder=[rgb]", "mlp_keys.encoder=[]"]
CARTPOLE = ["env=gym", "env.id=CartPole-v1", "mlp_keys.encoder=[state]"]
SHAPES = {
    "ppo": ["algo.rollout_steps=8", "per_rank_batch_size=4", "algo.update_epochs=2"],
    "a2c": ["per_rank_batch_size=64"],
    "ppo_recurrent": ["algo.rollout_steps=8", "per_rank_sequence_length=4", "per_rank_num_batches=2",
                      "algo.update_epochs=2", "algo.rnn.lstm.hidden_size=8"],
}
# gradient steps of one update: 2 epochs × 16 // 4 samples; A2C's one pass of min(64, 5·2); 2 epochs × 2 batches
STEPS = {"ppo": 8, "a2c": 1, "ppo_recurrent": 4}
CKPT_KEYS = {"params", "opt_state", "update", "last_log", "last_checkpoint"}


def _run(tmp_path, exp, extra, name):
    return cli.run([f"exp={exp}", *TINY, *SHAPES[exp], "fabric.accelerator=cpu", f"root_dir={tmp_path}/logs",
                    f"run_name={name}", *extra])


@pytest.mark.parametrize("exp,env", [
    ("ppo", "discrete_dummy"), ("ppo", "multidiscrete_dummy"), ("ppo", "continuous_dummy"),
    ("a2c", "discrete_dummy"), ("ppo_recurrent", "continuous_dummy"), ("ppo", "CartPole-v1"),
    ("a2c", "CartPole-v1"), ("ppo_recurrent", "CartPole-v1"),
])
def test_dry_run_through_the_cli(tmp_path, monkeypatch, exp, env):
    monkeypatch.chdir(tmp_path)
    base = CARTPOLE if env == "CartPole-v1" else PIXELS + [f"env.id={env}"]
    if exp == "ppo_recurrent" and env != "CartPole-v1":
        base = base + ["env.mask_velocities=False"]  # the preset masks CartPole's velocities
    result = _run(tmp_path, exp, base + ["dry_run=True"], "dry")
    steps = 5 if exp == "a2c" else 8
    assert (result["updates"], result["acting_steps"], result["gradient_steps"]) == (1, steps, STEPS[exp])
    assert result["policy_steps"] == 2 * steps and result["test_steps"] == 1
    assert result["graphs"]["train"]["eager_calls"] == STEPS[exp] and result["graphs"]["act"]["eager_calls"] == steps
    assert validate_checkpoint(result["checkpoint"], deep=True)["framework"] == "torch"
    state = read_checkpoint(result["checkpoint"], with_rb=False)
    assert CKPT_KEYS | {"num_batches" if exp == "ppo_recurrent" else "batch_size"} == set(state)
    assert set(state["opt_state"]) == {"state", "lr"}


def _served_and_evaluated(ckpt, steps=6, clients=3):
    """The gateway's actions for ``clients`` lockstep clients over ``steps``
    requests, and the evaluation policy's greedy actions on the same
    observations (its state, for PPO-recurrent, carried from a fresh one)."""
    model, cfg, observation_space, action_space = load_gateway_model(ckpt, device="cpu")
    rng = np.random.RandomState(0)
    frames = {k: rng.randn(steps, clients, *s.shape).astype(np.float32) for k, s in observation_space.items()}
    gateway = ServeGateway(model, max_batch=clients, deadline_s=60.0, seed=0)
    try:
        ids = [gateway.client(f"c{c}").client_id for c in range(clients)]
        served = []
        for t in range(steps):
            tickets = [gateway.batcher.submit(cid, {k: v[t, c] for k, v in frames.items()}, reset=t == 0)
                       for c, cid in enumerate(ids)]
            served.append([np.asarray(gateway.batcher.wait(tk, timeout=60.0)[0]).reshape(-1) for tk in tickets])
        assert gateway.drain(timeout=60.0)
    finally:
        gateway.close()
    policy = _builder_for(cfg.algo.name)(None, cfg, read_checkpoint(ckpt, with_rb=False), observation_space,
                                         action_space, device="cpu")
    state = None if policy.init_state is None else {k: v.expand(clients, *v.shape[1:]).clone()
                                                    for k, v in policy.init_state(1).items()}
    greedy = []
    for t in range(steps):
        actions, state = policy.act({k: v[t] for k, v in frames.items()}, state, torch.Generator())
        greedy.append(np.asarray(actions).reshape(clients, -1))
    return np.asarray(served), np.asarray(greedy)


@pytest.mark.parametrize("exp", ["ppo", "a2c", "ppo_recurrent"])
def test_train_resume_evaluate_and_serve(tmp_path, monkeypatch, exp):
    monkeypatch.chdir(tmp_path)
    per_update = 10 if exp == "a2c" else 16
    run = CARTPOLE + [f"total_steps={2 * per_update}", f"checkpoint.every={per_update}"]
    result = _run(tmp_path, exp, run, "first")
    assert result["updates"] == 2 and result["policy_steps"] == 2 * per_update
    ckpt = result["checkpoint"]
    state = read_checkpoint(ckpt, with_rb=False)
    assert int(state["update"]) == 2 and int(state["last_checkpoint"]) == 2 * per_update
    # resume from the first checkpoint: the JAX loop restarts at the checkpointed update
    first = ckpt.replace(f"ckpt_{2 * per_update}_0", f"ckpt_{per_update}_0")
    resumed = _run(tmp_path, exp, run + [f"checkpoint.resume_from={first}"], "resumed")
    assert resumed["updates"] == 2 and resumed["policy_steps"] == 3 * per_update
    evaluation = cli.evaluation([f"checkpoint_path={ckpt}", "fabric.accelerator=cpu", "eval.episodes=2",
                                 "eval.write_registry=False"])
    assert evaluation["n"] == 2 and np.isfinite(evaluation["mean"])
    served, greedy = _served_and_evaluated(ckpt)
    np.testing.assert_array_equal(served, greedy)
    assert probe_spaces(cli.load_run_config(ckpt)[0])[0]["state"].shape == (4,)


@pytest.mark.parametrize("exp", ["ppo", "a2c", "ppo_recurrent"])
def test_without_a_card_each_entrypoint_raises(tmp_path, monkeypatch, exp):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.run([f"exp={exp}", *TINY, *SHAPES[exp], *CARTPOLE, "dry_run=True", f"root_dir={tmp_path}/logs",
                 "run_name=x"])


@pytest.mark.parametrize("exp,extra,match", [
    ("ppo", ["env.backend=jax"], "SAC's training loop only"),
    ("a2c", ["env.act_burst=4"], "act_burst"),
    ("ppo_recurrent", ["algo.rollout_steps=6"], "multiple of the sequence length"),
])
def test_the_options_the_jax_entrypoints_refuse_raise(tmp_path, monkeypatch, exp, extra, match):
    monkeypatch.chdir(tmp_path)
    with pytest.raises((NotImplementedError, ValueError), match=match):
        _run(tmp_path, exp, CARTPOLE + ["dry_run=True"] + extra, "x")


def test_the_cartpole_stand_in_is_gymnasiums_cartpole():
    """``chip_smoke.cartpole_stand_in`` (the card's CartPole-v1 for the
    learning runs: the port's device CartPole on the CPU in float64) against
    gymnasium's ``CartPole-v1``: the same seeded resets, observations within
    1e-6 (gymnasium's float64 state cast to float32 on both sides), the same
    rewards, terminations and 500-step truncation over whole episodes; and
    its spec id masks the velocities as gymnasium's does."""
    import gymnasium as gym

    import chip_smoke
    from sheeprl_tpu_torch.envs.wrappers import MaskVelocityWrapper

    stand_in, ref = chip_smoke.cartpole_stand_in("CartPole-v1", render_mode="rgb_array"), gym.make("CartPole-v1")
    assert stand_in.observation_space.shape == ref.observation_space.shape and stand_in.action_space.n == 2
    rng = np.random.RandomState(0)
    for episode, seed in enumerate((3, None, 11)):
        a, _ = stand_in.reset(seed=seed)
        b, _ = ref.reset(seed=seed)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        steps, done = 0, False
        while not done:
            # episode 2 balances by hand (push toward the pole's lean) until the time limit truncates it
            action = int(b[2] + 0.5 * b[3] > 0) if episode == 2 else int(rng.randint(0, 2))
            out_a, out_b = stand_in.step(np.asarray(action)), ref.step(action)
            np.testing.assert_allclose(out_a[0], out_b[0], rtol=0, atol=1e-6)
            assert out_a[1:4] == out_b[1:4]
            a, b, done, steps = out_a[0], out_b[0], out_a[2] or out_a[3], steps + 1
        if episode == 2:
            assert out_a[3] and steps == 500
    masked = MaskVelocityWrapper(stand_in).reset(seed=1)[0]
    assert masked[1] == 0.0 and masked[3] == 0.0 and masked[0] != 0.0

"""JAX-package checkpoints of PPO, A2C and PPO-recurrent (tiny JAX dry
runs on gymnasium's CartPole) in the port, on the CPU:

- resumed: the agent's parameters are the converted flax params, the
  optimizer's moments, step count and learning rate the converted optax
  state, and the port's CLI trains on from the checkpoint;
- served: the gateway's greedy actions equal the JAX package's eval
  policy's on the same observations (PPO-recurrent's over three steps of
  carried state).
"""

from __future__ import annotations

import glob
import os
from types import SimpleNamespace

import gymnasium as gym
import jax
import numpy as np
import pytest
from jax_cli_switches import run_jax_cli
import torch

from sheeprl_tpu.ckpt.resume import read_checkpoint as jax_read_checkpoint
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.ppo.ppo import build_optimizer, load_resume
from sheeprl_tpu_torch.convert import onpolicy_converter
from sheeprl_tpu_torch.evals.builders import actions_dim_of
from sheeprl_tpu_torch.evals.service import probe_spaces
from sheeprl_tpu_torch.fabric import Fabric
from sheeprl_tpu_torch.serve.model import load_gateway_model
from test_torch_ppo import restore_prng_impl  # noqa: F401  (a module fixture: the JAX CLI's Fabric)
from test_torch_ppo_cli import CARTPOLE, SHAPES, TINY


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Tiny JAX dry runs of each family; their checkpoint directories. The
    JAX CLI turns its aggregator and timer off for ``metric.log_level=0``
    for the whole process: both are put back."""
    from sheeprl_tpu.utils.metric import MetricAggregator
    from sheeprl_tpu.utils.timer import timer

    root = tmp_path_factory.mktemp("jax_ppo")
    cwd = os.getcwd()
    os.chdir(root)
    saved = MetricAggregator.disabled, timer.disabled
    runs = {}
    try:
        for exp in SHAPES:
            run_jax_cli([f"exp={exp}", *TINY, *SHAPES[exp], *CARTPOLE, "fabric.accelerator=cpu", "dry_run=True",
                         "algo.run_test=False", f"root_dir={root}/logs", f"run_name={exp}"])
            runs[exp] = sorted(glob.glob(f"{root}/logs/**/{exp}/**/ckpt_*_0", recursive=True))[-1]
    finally:
        os.chdir(cwd)
        MetricAggregator.disabled, timer.disabled = saved
    return runs


@pytest.mark.parametrize("exp", list(SHAPES))
def test_a_jax_checkpoint_resumes_in_the_port(jax_runs, tmp_path, monkeypatch, exp):
    ckpt = jax_runs[exp]
    cfg, _ = cli.load_run_config(ckpt)
    cfg.checkpoint.resume_from = ckpt
    observation_space, action_space = probe_spaces(cfg)
    actions_dim, is_continuous = actions_dim_of(action_space)
    module = "ppo_recurrent.agent" if exp == "ppo_recurrent" else "ppo.agent"
    build_agent = __import__(f"sheeprl_tpu_torch.algos.{module}", fromlist=["build_agent"]).build_agent
    agent = build_agent(cfg, actions_dim, is_continuous, list(cfg.cnn_keys.encoder), list(cfg.mlp_keys.encoder),
                        observation_space)
    optimizer = build_optimizer(cfg, agent)
    family = SimpleNamespace(agent=agent, optimizer=optimizer,
                             batch_entry="num_batches" if exp == "ppo_recurrent" else "batch_size")
    state = load_resume(Fabric(accelerator="cpu"), cfg, family)
    jax_state = jax_read_checkpoint(ckpt)
    want = onpolicy_converter(exp)(jax_state["params"])
    for name, p in agent.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[name].numpy(), err_msg=name)
    steps = 4 if exp == "ppo_recurrent" else (8 if exp == "ppo" else 1)
    lrs = {p: float(optimizer.lr) for p in agent.parameters()}
    assert all(lr == pytest.approx(float(cfg.algo.optimizer.lr)) for lr in lrs.values())
    assert all(float(optimizer.state[p]["step"]) == steps for p in agent.parameters())
    assert all(float(optimizer.state[p]["exp_avg"].abs().sum()) > 0 for p in agent.parameters())
    assert int(state["update"]) == 1
    # the port's CLI trains on from it (the JAX loop's counters: the checkpointed update runs again)
    monkeypatch.chdir(tmp_path)
    per_update = 10 if exp == "a2c" else 16
    result = cli.run([f"exp={exp}", *TINY, *SHAPES[exp], *CARTPOLE, f"checkpoint.resume_from={ckpt}",
                      "fabric.accelerator=cpu", "dry_run=False", f"total_steps={2 * per_update}",
                      f"root_dir={tmp_path}/logs", "run_name=resumed"])
    assert result["updates"] == 2 and result["policy_steps"] == 3 * per_update


@pytest.mark.parametrize("exp", list(SHAPES))
def test_a_jax_checkpoint_is_served_with_the_jax_actions(jax_runs, exp):
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.evals.service import find_eval_builder as jax_find_eval_builder

    import sheeprl_tpu.algos.ppo.evaluate  # noqa: F401  (registers the JAX builders)
    import sheeprl_tpu.algos.ppo_recurrent.evaluate  # noqa: F401

    ckpt = jax_runs[exp]
    model, cfg, observation_space, action_space = load_gateway_model(ckpt, device="cpu")
    assert model.algo == exp and (model.init_state_rows(3) is None) == (exp != "ppo_recurrent")
    jax_cfg = jax_compose(overrides=[f"exp={exp}", *TINY, *SHAPES[exp], *CARTPOLE])
    gym_obs = gym.spaces.Dict({k: gym.spaces.Box(s.low, s.high, s.shape, s.dtype)
                               for k, s in observation_space.items()})
    jax_policy = jax_find_eval_builder(exp)(None, jax_cfg, jax_read_checkpoint(ckpt), gym_obs,
                                            gym.spaces.Discrete(int(action_space.n)))
    rng = np.random.RandomState(0)
    state, jax_state = model.init_state_rows(3), None if exp != "ppo_recurrent" else jax_policy.init_state(3)
    for _ in range(3):
        obs = {k: rng.randn(3, *space.shape).astype(np.float32) for k, space in observation_space.items()}
        actions, state = model.act(obs, state, torch.Generator())
        want, jax_state = jax_policy.act(obs, jax_state, jax.random.PRNGKey(0))
        np.testing.assert_array_equal(np.asarray(actions).reshape(3, -1), np.asarray(want).reshape(3, -1))

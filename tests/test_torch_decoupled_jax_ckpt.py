"""JAX-package checkpoints of ``sac_decoupled`` and ``ppo_decoupled`` (tiny
JAX dry runs at ``fabric.devices=2`` on the CPU, as the JAX package's own
tests run them) in the port:

- resumed: the learner's modules and optimizers hold the converted flax
  params and optax state (``convert_sac``/``convert_ppo``,
  ``convert_optax_state``), and the port's CLI trains on from the
  checkpoint at ``fabric.devices=auto``;
- served: the gateway's greedy actions equal the JAX package's eval
  policy's on the same observations (SAC's within 1e-5, the frameworks'
  float32 forward passes; PPO's argmax actions exactly).
"""

from __future__ import annotations

import glob
import os
from types import SimpleNamespace

import gymnasium as gym
import jax
import numpy as np
import pytest
import torch

from sheeprl_tpu import cli as jax_cli
from sheeprl_tpu.ckpt.resume import read_checkpoint as jax_read_checkpoint
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.fabric import Fabric
from sheeprl_tpu_torch.serve.model import load_gateway_model
from test_torch_ppo import restore_prng_impl  # noqa: F401  (a module fixture: the JAX CLI's Fabric)

TINY = ["fabric.devices=2", "env.capture_video=False", "env.num_envs=1", "buffer.memmap=False", "metric.log_level=0",
        "algo.run_test=False"]
RUNS = {
    "sac_decoupled": ["env.id=Pendulum-v1", "algo.hidden_size=8", "per_rank_batch_size=4", "buffer.size=64"],
    "ppo_decoupled": ["env.id=CartPole-v1", "algo.rollout_steps=8", "per_rank_batch_size=4", "algo.update_epochs=2",
                      "algo.dense_units=8", "algo.encoder.mlp_features_dim=8"],
}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Tiny JAX dry runs of both decoupled entrypoints; their checkpoint
    directories. The JAX CLI's aggregator and timer switches are put back."""
    from sheeprl_tpu.utils.metric import MetricAggregator
    from sheeprl_tpu.utils.timer import timer

    root = tmp_path_factory.mktemp("jax_decoupled")
    cwd = os.getcwd()
    os.chdir(root)
    saved = MetricAggregator.disabled, timer.disabled
    runs = {}
    try:
        for exp, extra in RUNS.items():
            jax_cli.run([f"exp={exp}", *TINY, *extra, "fabric.accelerator=cpu", "dry_run=True",
                         f"root_dir={root}/logs", f"run_name={exp}"])
            runs[exp] = sorted(glob.glob(f"{root}/logs/**/{exp}/**/ckpt_*_0", recursive=True))[-1]
    finally:
        os.chdir(cwd)
        MetricAggregator.disabled, timer.disabled = saved
    return runs


def _resume_cfg(ckpt):
    cfg, _ = cli.load_run_config(ckpt)
    cfg.checkpoint.resume_from = ckpt
    cfg.fabric.devices = "auto"
    return cfg


def test_a_jax_sac_decoupled_checkpoint_resumes_in_the_port(jax_runs, tmp_path, monkeypatch):
    from sheeprl_tpu_torch.algos.sac.agent import build_agent_state
    from sheeprl_tpu_torch.algos.sac.sac import build_optimizers_and_state
    from sheeprl_tpu_torch.algos.sac.sac_decoupled import read_sac_resume
    from sheeprl_tpu_torch.convert import convert_sac

    ckpt = jax_runs["sac_decoupled"]
    cfg = _resume_cfg(ckpt)
    state = build_optimizers_and_state(cfg, build_agent_state(3, 1, 8, 8, int(cfg.algo.critic.n), 1.0, None))
    resumed = read_sac_resume(Fabric(accelerator="cpu"), cfg, state)
    jax_state = jax_read_checkpoint(ckpt)
    want, _ = convert_sac(jax_state["agent"], training=True)
    for name in ("actor", "critics", "target_critics"):
        for pname, p in state[name].named_parameters():
            np.testing.assert_array_equal(p.detach().numpy(), want[name][pname].numpy(), err_msg=f"{name}.{pname}")
    np.testing.assert_array_equal(state["log_alpha"].detach().numpy(), np.asarray(want["log_alpha"]).reshape(1))
    for opt in state["opt"].values():
        assert all(float(opt.state[p]["step"]) == 1 for g in opt.param_groups for p in g["params"])
    assert int(resumed["update"]) == 2 and cfg.per_rank_batch_size == 8  # the JAX global batch, 2 devices x 4
    monkeypatch.chdir(tmp_path)
    result = cli.run(["exp=sac_decoupled", *TINY[1:], *RUNS["sac_decoupled"], f"checkpoint.resume_from={ckpt}",
                      "fabric.devices=auto", "fabric.accelerator=cpu", "dry_run=False", "total_steps=6",
                      "algo.learning_starts=0", f"root_dir={tmp_path}/logs", "run_name=resumed"])
    assert result["updates"] == 5 and result["gradient_steps"] > 0  # the checkpointed update 2 runs again, to 6


def test_a_jax_ppo_decoupled_checkpoint_resumes_in_the_port(jax_runs, tmp_path, monkeypatch):
    from sheeprl_tpu_torch.algos.ppo.agent import build_agent
    from sheeprl_tpu_torch.algos.ppo.ppo import build_optimizer, load_resume
    from sheeprl_tpu_torch.convert import convert_ppo
    from sheeprl_tpu_torch.evals.builders import actions_dim_of
    from sheeprl_tpu_torch.evals.service import probe_spaces

    ckpt = jax_runs["ppo_decoupled"]
    cfg = _resume_cfg(ckpt)
    observation_space, action_space = probe_spaces(cfg)
    actions_dim, is_continuous = actions_dim_of(action_space)
    agent = build_agent(cfg, actions_dim, is_continuous, [], list(cfg.mlp_keys.encoder), observation_space)
    optimizer = build_optimizer(cfg, agent)
    state = load_resume(Fabric(accelerator="cpu"), cfg,
                        SimpleNamespace(agent=agent, optimizer=optimizer, batch_entry="batch_size"))
    want = convert_ppo(jax_read_checkpoint(ckpt)["params"])
    for name, p in agent.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[name].numpy(), err_msg=name)
    # 2 epochs of the per-device 8 rows (1 env x 8 steps) in minibatches of 4
    assert all(float(optimizer.state[p]["step"]) == 4 for p in agent.parameters())
    assert int(state["update"]) == 2
    monkeypatch.chdir(tmp_path)
    result = cli.run(["exp=ppo_decoupled", *TINY[1:], *RUNS["ppo_decoupled"], f"checkpoint.resume_from={ckpt}",
                      "fabric.devices=auto", "fabric.accelerator=cpu", "dry_run=False", "total_steps=24",
                      f"root_dir={tmp_path}/logs", "run_name=resumed"])
    assert result["updates"] == 2 and result["policy_steps"] == 24  # updates 2 and 3 of 8 steps of 1 env


@pytest.mark.parametrize("exp", list(RUNS))
def test_a_jax_decoupled_checkpoint_is_served_with_the_jax_actions(jax_runs, exp):
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.evals.service import find_eval_builder as jax_find_eval_builder

    import sheeprl_tpu.algos.ppo.evaluate  # noqa: F401  (registers the JAX builders)
    import sheeprl_tpu.algos.sac.evaluate  # noqa: F401

    ckpt = jax_runs[exp]
    model, cfg, observation_space, action_space = load_gateway_model(ckpt, device="cpu")
    assert model.algo == exp and model.init_state_rows(3) is None
    jax_cfg = jax_compose(overrides=[f"exp={exp}", *TINY, *RUNS[exp]])
    gym_obs = gym.spaces.Dict({k: gym.spaces.Box(s.low, s.high, s.shape, s.dtype) for k, s in observation_space.items()})
    gym_act = (gym.spaces.Box(action_space.low, action_space.high, action_space.shape, action_space.dtype)
               if exp == "sac_decoupled" else gym.spaces.Discrete(int(action_space.n)))
    jax_policy = jax_find_eval_builder(exp)(None, jax_cfg, jax_read_checkpoint(ckpt), gym_obs, gym_act)
    obs = {k: np.random.RandomState(0).randn(3, *s.shape).astype(np.float32) for k, s in observation_space.items()}
    actions = np.asarray(model.act(obs, None, torch.Generator())[0]).reshape(3, -1)
    want = np.asarray(jax_policy.act(obs, None, jax.random.PRNGKey(0))[0]).reshape(3, -1)
    if exp == "sac_decoupled":
        np.testing.assert_allclose(actions, want, rtol=0, atol=1e-5)
    else:
        np.testing.assert_array_equal(actions, want)

"""The port's DreamerV1 and Plan2Explore-DV1 runs, evaluation and serving on
the CPU, at a tiny width on the dummy env.

- ``exp=dreamer_v1`` through the port's CLI: gradient steps that move the
  weights, a checkpoint (modules, optimizers, ``expl_decay_steps``, the
  sequential buffer) and a resume from it.
- ``exp=p2e_dv1_exploration``, then ``exp=p2e_dv1_finetuning`` from its
  checkpoint (the actor switch at ``learning_starts``), then the
  ``evaluation`` command on the finetuning checkpoint (the task actor).
- Finetuning from a JAX P2E-DV1 exploration checkpoint (written by the JAX
  package's own writer): every tree converted and carried over.
- A tiny JAX DreamerV1 dry run's checkpoint served by the port's
  ``load_gateway_model``: the actions the JAX package's gateway serves for
  the same frames and the same posterior noise injected on both sides (the
  greedy action is the actor's mode). Three chained steps; recurrent and
  stochastic state within atol 1e-4, actions equal.
"""

import os
from pathlib import Path

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu import cli as jax_cli
from sheeprl_tpu.algos.dreamer_v1 import agent as jax_agent
from sheeprl_tpu.algos.p2e_dv1 import agent as jax_p2e_agent
from sheeprl_tpu.ckpt import validate_checkpoint as jax_validate_checkpoint
from sheeprl_tpu.ckpt.writer import write_checkpoint as jax_write_checkpoint
from sheeprl_tpu.config import compose
from sheeprl_tpu.serve.model import load_gateway_model as jax_load_gateway_model
from sheeprl_tpu.utils.utils import save_configs as jax_save_configs
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.dreamer_v1.agent import build_agent
from sheeprl_tpu_torch.ckpt import read_checkpoint, validate_checkpoint
from sheeprl_tpu_torch.convert import convert_p2e_dv1
from sheeprl_tpu_torch.evals.builders import serving_params
from sheeprl_tpu_torch.serve.model import load_gateway_model

S = 4  # the tiny runs' stochastic size
ROWS, STEPS = 3, 3
TINY = [
    "env=dummy", "env.id=discrete_dummy", "env.num_envs=2", "env.sync_env=True", "env.capture_video=False",
    "metric.log_level=0", "buffer.memmap=False", "checkpoint.every=1000000", "per_rank_batch_size=2",
    "per_rank_sequence_length=4", "algo.horizon=3", "algo.dense_units=8", "algo.mlp_layers=1",
    "algo.world_model.encoder.cnn_channels_multiplier=2", "algo.world_model.recurrent_model.recurrent_state_size=8",
    "algo.world_model.transition_model.hidden_size=8", "algo.world_model.representation_model.hidden_size=8",
    f"algo.world_model.stochastic_size={S}", "cnn_keys.encoder=[rgb]", "algo.train_every=2",
    "algo.per_rank_gradient_steps=1",
]
PORT = TINY + ["fabric.accelerator=cpu"]
P2E = PORT + ["algo.ensembles.n=3", "buffer.size=64"]


def test_the_port_cli_trains_checkpoints_and_resumes(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    run = ["exp=dreamer_v1", "total_steps=24", "algo.learning_starts=12", "buffer.size=64", "buffer.checkpoint=True",
           "algo.actor.expl_decay=True", f"root_dir={tmp_path}/logs"]
    result = cli.run(PORT + run + ["run_name=port"])
    # 12 updates of 2 envs: 6 random, then one gradient step an update from update 6 (no pretraining burst)
    assert (result["updates"], result["random_steps"], result["player_steps"]) == (12, 6, 6)
    assert result["gradient_steps"] == 7 and result["test_steps"] > 0
    assert result["graphs"]["train"]["eager_calls"] == 7
    ckpt = result["checkpoint"]
    manifest = jax_validate_checkpoint(ckpt, deep=True)
    assert manifest["framework"] == "torch" and manifest["algo"] == "dreamer_v1"
    state = read_checkpoint(ckpt)
    assert set(state["agent"]) == {"world_model", "actor", "critic", "opt"}
    assert int(state["expl_decay_steps"]) == 7 and "rb" in state
    assert "rssm.recurrent_model.gru.hn.bias" in state["agent"]["world_model"]
    # the gradient steps moved every world-model parameter off the seeded initialization (free nats clamp the
    # KL at this width, so the prior's transition model alone keeps its weights)
    cfg, _ = cli.load_run_config(ckpt)
    fresh, _ = build_agent(cfg, (2,), False, {"rgb": (3, 64, 64)}, device="cpu")
    still = {k for k, v in fresh.state_dict().items() if np.array_equal(v.numpy(), state["agent"]["world_model"][k])}
    assert all(k.startswith("rssm.transition_model.") for k in still)
    assert "rssm.recurrent_model.gru.ir.weight" not in still

    resumed = cli.run(PORT + run[:1] + ["total_steps=32"] + run[2:] + [f"checkpoint.resume_from={ckpt}",
                                                                       "run_name=resumed"])
    # the JAX loop's resume: from the checkpoint's update (12) to 16, acting and training every update
    assert (resumed["updates"], resumed["random_steps"], resumed["player_steps"], resumed["gradient_steps"]) == (
        5, 0, 5, 5)
    state = read_checkpoint(resumed["checkpoint"], with_rb=False)
    assert resumed["checkpoint"].endswith("ckpt_34_0") and int(state["expl_decay_steps"]) == 12


@pytest.fixture(scope="module")
def exploration_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("p2e_dv1")
    result = cli.run(P2E + ["exp=p2e_dv1_exploration", "total_steps=24", "algo.learning_starts=12",
                            f"root_dir={root}", "run_name=expl"])
    return root, result


def test_exploration_then_finetuning_then_evaluation(exploration_run):
    root, expl = exploration_run
    assert expl["gradient_steps"] == 7 and expl["random_steps"] == 6 and expl["player_steps_by_actor"] == [6]
    validate_checkpoint(expl["checkpoint"])
    agent = read_checkpoint(expl["checkpoint"], with_rb=False)["agent"]
    trees = {"world_model", "actor_task", "critic_task", "actor_exploration", "critic_exploration", "ensembles"}
    assert set(agent) == trees | {"opt"} and set(agent["opt"]) == trees
    # the ensemble regresses the 2·8·2·2 = 64-wide CNN embedding
    assert agent["ensembles"]["head.weight"].shape == (3, 8, 64)

    result = cli.run(P2E + ["exp=p2e_dv1_finetuning", f"checkpoint.exploration_ckpt_path={expl['checkpoint']}",
                            "total_steps=20", "algo.learning_starts=12", f"root_dir={root}", "run_name=fntn"])
    assert result["random_steps"] == 0 and result["player_steps_by_actor"] == [5, 5]
    assert result["actor_switched_at"] == 6 and result["gradient_steps"] == 5
    validate_checkpoint(result["checkpoint"])
    ckpt = read_checkpoint(result["checkpoint"], with_rb=False)
    assert set(ckpt["agent"]) == {"world_model", "actor", "critic", "opt"}
    for k, v in ckpt["actor_exploration"].items():
        np.testing.assert_array_equal(v, agent["actor_exploration"][k])
    for k, v in serving_params(ckpt, "p2e_dv1_finetuning")["actor"].items():
        np.testing.assert_array_equal(v.numpy(), ckpt["agent"]["actor"][k])
    for path, algo in ((expl["checkpoint"], "p2e_dv1_exploration"), (result["checkpoint"], "p2e_dv1_finetuning")):
        scored = cli.evaluation([f"checkpoint_path={path}", "fabric.accelerator=cpu", "eval.episodes=2",
                                 f"eval.registry_dir={root}/registry"])
        assert scored["n"] == 2 and scored["algo"] == algo and len(scored["returns"]) == 2
    with open(f"{root}/registry/registry.jsonl") as f:
        assert sum(1 for line in f if line.strip()) == 2


@pytest.fixture(scope="module")
def jax_exploration_run(tmp_path_factory):
    """A JAX P2E-DV1 exploration checkpoint at the tiny width, written by the
    JAX package's own writer beside its persisted config (the optimizer
    state, which finetuning does not read, left out); its trees have the
    JAX ``build_agent``'s layout (``jax.eval_shape``), seeded values."""
    log_dir = tmp_path_factory.mktemp("jax_p2e_dv1") / "jax" / "version_0"
    jcfg = compose(overrides=TINY + ["exp=p2e_dv1_exploration", "algo.ensembles.n=3"])
    space = gym.spaces.Dict({"rgb": gym.spaces.Box(0, 255, (3, 64, 64), np.uint8)})
    shapes = jax.eval_shape(lambda k: jax_p2e_agent.build_agent(jcfg, (2,), False, space, k)[-1],
                            jax.random.PRNGKey(5))
    rng = np.random.RandomState(5)
    params = jax.tree_util.tree_map(lambda s: (0.1 * rng.randn(*s.shape)).astype(s.dtype), shapes)
    state = {"agent": {"params": params}, "expl_decay_steps": 2, "update": 8, "batch_size": 2,
             "last_log": 0, "last_checkpoint": 16}
    jax_save_configs(jcfg, str(log_dir))
    ckpt = str(log_dir / "checkpoint" / "ckpt_16_0")
    jax_write_checkpoint(ckpt, state, step=16, algo="p2e_dv1_exploration")
    return ckpt


def test_finetuning_from_a_jax_exploration_checkpoint(jax_exploration_run, tmp_path):
    """No gradient step before the checkpoint: every tree of the finetuning
    checkpoint equals the converted JAX one."""
    result = cli.run(P2E + ["exp=p2e_dv1_finetuning", f"checkpoint.exploration_ckpt_path={jax_exploration_run}",
                            "total_steps=8", "algo.learning_starts=100", f"root_dir={tmp_path}", "run_name=fntn_jax"])
    assert result["player_steps_by_actor"] == [4, 0] and result["gradient_steps"] == 0
    converted, _ = convert_p2e_dv1(read_checkpoint(jax_exploration_run, with_rb=False)["agent"]["params"],
                                   training=True)
    ckpt = read_checkpoint(result["checkpoint"], with_rb=False)
    for name, jax_name in (("world_model", "world_model"), ("actor", "actor_task"), ("critic", "critic_task")):
        for k, v in converted[jax_name].items():
            np.testing.assert_array_equal(ckpt["agent"][name][k], v.numpy(), err_msg=f"{name}.{k}")
    for k, v in converted["actor_exploration"].items():
        np.testing.assert_array_equal(ckpt["actor_exploration"][k], v.numpy())
    assert int(ckpt["expl_decay_steps"]) == 2


def _checkpoint(root):
    found = sorted(Path(root).rglob("ckpt_*_0"))
    assert len(found) == 1, found
    return str(found[0])


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """One tiny JAX DreamerV1 dry run; returns its checkpoint directory. The
    JAX CLI turns its aggregator and timer off for ``metric.log_level=0``
    and leaves them so: they are put back for the tests that follow."""
    from sheeprl_tpu.utils.metric import MetricAggregator
    from sheeprl_tpu.utils.timer import timer

    root = tmp_path_factory.mktemp("jax_dv1")
    cwd = os.getcwd()
    os.chdir(root)
    saved = MetricAggregator.disabled, timer.disabled
    try:
        jax_cli.run(TINY + ["exp=dreamer_v1", "fabric.accelerator=cpu", "dry_run=True", "per_rank_sequence_length=1",
                            "algo.learning_starts=0", f"root_dir={root}/logs", "run_name=jax"])
    finally:
        os.chdir(cwd)
        MetricAggregator.disabled, timer.disabled = saved
    return _checkpoint(root / "logs")


def test_a_jax_checkpoint_serves_the_jax_actions(jax_run, monkeypatch):
    rng = np.random.RandomState(0)
    posterior_noise = rng.randn(ROWS, S).astype(np.float32)
    frames = [rng.randint(0, 256, (ROWS, 3, 64, 64)).astype(np.uint8) for _ in range(STEPS)]

    # the JAX policy samples its posterior inside a jitted step: inject the same noise there
    sample_state = jax_agent.compute_stochastic_state

    def injected_state(state_information, key, min_std=0.1, noise=None):
        if key is not None and state_information.shape[0] == ROWS:
            noise = jnp.asarray(posterior_noise)
        return sample_state(state_information, key, min_std, noise=noise)

    monkeypatch.setattr(jax_agent, "compute_stochastic_state", injected_state)
    jax_model, *_ = jax_load_gateway_model(jax_run)
    model, cfg, observation_space, action_space = load_gateway_model(jax_run, device="cpu")
    assert (model.version, model.algo, model.env_id) == (jax_model.version, "dreamer_v1", "discrete_dummy")
    assert action_space.n == 2 and observation_space["rgb"].shape == (3, 64, 64)

    jax_state, state = jax_model.init_state_rows(ROWS), model.init_state_rows(ROWS)
    for obs in frames:
        jax_actions, jax_state = jax_model.act({"rgb": obs}, jax_state, jax.random.PRNGKey(0))
        actions, state = model.policy.act({"rgb": obs}, state, None, gumbel=torch.from_numpy(posterior_noise))
        np.testing.assert_array_equal(actions, np.asarray(jax_actions))
        for k in ("recurrent", "stochastic"):
            np.testing.assert_allclose(state[k].numpy(), np.asarray(jax_state[k]), atol=1e-4, rtol=0, err_msg=k)


def test_in_run_evaluation_scores_the_dv1_run(tmp_path, monkeypatch):
    """``eval.every_n_steps`` on a DV1 run: the run publishes its acting
    modules past ``learning_starts`` and the spawned eval process (on the
    CPU, DreamerV1's registered builder) writes its curve."""
    import json

    from sheeprl_tpu_torch.obs.dist.aggregate import sidecar_path

    monkeypatch.chdir(tmp_path)
    result = cli.run(PORT + ["exp=dreamer_v1", "total_steps=24", "algo.learning_starts=12", "buffer.size=64",
                             "eval.every_n_steps=8", "eval.inrun_episodes=2", "algo.run_test=False",
                             f"root_dir={tmp_path}/logs", "run_name=inrun"])
    assert result["inrun_publishes"] >= 2 and result["gradient_steps"] == 7
    with open(sidecar_path(os.path.join(result["log_dir"], "telemetry"), "evalproc")) as f:
        curve = json.load(f)
    assert curve["episodes"] == 2 and curve["points"] and curve["cuda_initialized"] is False
    versions = [p["policy_version"] for p in curve["points"]]
    assert versions == sorted(versions) and all(np.isfinite(p["mean"]) for p in curve["points"])

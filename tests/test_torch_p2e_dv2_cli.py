"""The port's Plan2Explore on DreamerV2 through its CLI on the CPU, at a
tiny width on the dummy env: an exploration run (every module and optimizer
state in its checkpoint, under the JAX names), finetuning from its
checkpoint (the actor switch at ``learning_starts``), finetuning from a JAX
exploration checkpoint (written by the JAX package's own writer, every tree
converted and carried over), and the evaluation of both phases'
checkpoints, which plays the task actor."""

import gymnasium as gym
import jax
import numpy as np
import pytest

from sheeprl_tpu.algos.p2e_dv2 import agent as jax_agent
from sheeprl_tpu.ckpt.writer import write_checkpoint as jax_write_checkpoint
from sheeprl_tpu.config import compose
from sheeprl_tpu.utils.utils import save_configs as jax_save_configs
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.ckpt import read_checkpoint, validate_checkpoint
from sheeprl_tpu_torch.convert import convert_p2e_dv2
from sheeprl_tpu_torch.evals.builders import serving_params

TINY = [
    "env=dummy", "env.id=discrete_dummy", "env.num_envs=2", "env.sync_env=True", "env.capture_video=False",
    "fabric.accelerator=cpu", "metric.log_level=0", "buffer.memmap=False", "checkpoint.every=1000000",
    "per_rank_batch_size=2", "per_rank_sequence_length=4", "algo.horizon=2", "algo.dense_units=8",
    "algo.mlp_layers=1", "algo.world_model.encoder.cnn_channels_multiplier=2",
    "algo.world_model.recurrent_model.recurrent_state_size=8", "algo.world_model.transition_model.hidden_size=8",
    "algo.world_model.representation_model.hidden_size=8", "algo.world_model.stochastic_size=4",
    "algo.world_model.discrete_size=4", "algo.ensembles.n=3", "cnn_keys.encoder=[rgb]", "algo.train_every=2",
    "algo.per_rank_pretrain_steps=1",
]
TREES = ("world_model", "actor_task", "critic_task", "target_critic_task", "actor_exploration", "critic_exploration",
         "target_critic_exploration", "ensembles")


@pytest.fixture(scope="module")
def exploration_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("p2e_dv2")
    result = cli.run(TINY + ["exp=p2e_dv2_exploration", "total_steps=24", "algo.learning_starts=12",
                             "buffer.size=64", f"root_dir={root}", "run_name=expl"])
    return root, result


def test_exploration_run_writes_every_module(exploration_run):
    _root, result = exploration_run
    assert result["gradient_steps"] == 7 and result["random_steps"] == 6
    assert result["player_steps_by_actor"] == [6] and result["test_steps"] > 0
    validate_checkpoint(result["checkpoint"])
    agent = read_checkpoint(result["checkpoint"], with_rb=False)["agent"]
    assert set(agent) == set(TREES) | {"opt"}
    assert set(agent["opt"]) == {"world_model", "ensembles", "actor_task", "critic_task", "actor_exploration",
                                 "critic_exploration"}
    # DreamerV2's ensemble: no LayerNorm, biases on every layer
    assert agent["ensembles"]["mlp.blocks.0.linear.bias"].shape == (3, 8)


def test_finetuning_switches_actors_and_evaluates_the_task_actor(exploration_run):
    root, expl = exploration_run
    result = cli.run(TINY + ["exp=p2e_dv2_finetuning", f"checkpoint.exploration_ckpt_path={expl['checkpoint']}",
                             "total_steps=20", "algo.learning_starts=12", "buffer.size=64", f"root_dir={root}",
                             "run_name=fntn"])
    assert result["random_steps"] == 0 and result["player_steps_by_actor"] == [5, 5]
    assert result["actor_switched_at"] == 6 and result["gradient_steps"] == 5
    validate_checkpoint(result["checkpoint"])
    ckpt = read_checkpoint(result["checkpoint"], with_rb=False)
    assert set(ckpt["agent"]) == {"world_model", "actor", "critic", "target_critic", "opt"}
    expl_agent = read_checkpoint(expl["checkpoint"], with_rb=False)["agent"]
    for k, v in ckpt["actor_exploration"].items():
        np.testing.assert_array_equal(v, expl_agent["actor_exploration"][k])
    for k, v in serving_params(ckpt, "p2e_dv2_finetuning")["actor"].items():
        np.testing.assert_array_equal(v.numpy(), ckpt["agent"]["actor"][k])
    for k, v in serving_params({"agent": expl_agent}, "p2e_dv2_exploration")["actor"].items():
        np.testing.assert_array_equal(v.numpy(), expl_agent["actor_task"][k])
    for path in (expl["checkpoint"], result["checkpoint"]):
        scored = cli.evaluation([f"checkpoint_path={path}", "fabric.accelerator=cpu", "eval.episodes=2",
                                 "eval.write_registry=False"])
        assert scored["n"] == 2 and scored["algo"].startswith("p2e_dv2_")


@pytest.fixture(scope="module")
def jax_exploration_run(tmp_path_factory):
    """A JAX P2E-DV2 exploration checkpoint at the tiny width, written by the
    JAX package's own writer beside its persisted config (the optimizer
    state, which finetuning does not read, left out)."""
    log_dir = tmp_path_factory.mktemp("jax_p2e_dv2") / "jax" / "version_0"
    jcfg = compose(overrides=[o for o in TINY if o != "fabric.accelerator=cpu"] + ["exp=p2e_dv2_exploration"])
    space = gym.spaces.Dict({"rgb": gym.spaces.Box(0, 255, (3, 64, 64), np.uint8)})
    *_, params = jax_agent.build_agent(jcfg, (2,), False, space, jax.random.PRNGKey(5))
    state = {"agent": {"params": jax.device_get(params)}, "expl_decay_steps": 2, "update": 8, "batch_size": 2,
             "last_log": 0, "last_checkpoint": 16}
    jax_save_configs(jcfg, str(log_dir))
    ckpt = str(log_dir / "checkpoint" / "ckpt_16_0")
    jax_write_checkpoint(ckpt, state, step=16, algo="p2e_dv2_exploration")
    return ckpt


def test_finetuning_from_a_jax_exploration_checkpoint(jax_exploration_run, tmp_path):
    """No gradient step before the checkpoint: every tree of the finetuning
    checkpoint equals the converted JAX one."""
    result = cli.run(TINY + ["exp=p2e_dv2_finetuning", f"checkpoint.exploration_ckpt_path={jax_exploration_run}",
                             "total_steps=8", "algo.learning_starts=100", "buffer.size=64", f"root_dir={tmp_path}",
                             "run_name=fntn_jax"])
    assert result["player_steps_by_actor"] == [4, 0] and result["gradient_steps"] == 0
    converted, _ = convert_p2e_dv2(read_checkpoint(jax_exploration_run, with_rb=False)["agent"]["params"],
                                   training=True)
    ckpt = read_checkpoint(result["checkpoint"], with_rb=False)
    for name, jax_name in (("world_model", "world_model"), ("actor", "actor_task"), ("critic", "critic_task"),
                           ("target_critic", "target_critic_task")):
        for k, v in converted[jax_name].items():
            np.testing.assert_array_equal(ckpt["agent"][name][k], v.numpy(), err_msg=f"{name}.{k}")
    for k, v in converted["actor_exploration"].items():
        np.testing.assert_array_equal(ckpt["actor_exploration"][k], v.numpy())
    assert int(ckpt["expl_decay_steps"]) == 2

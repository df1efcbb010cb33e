"""The port's Plan2Explore on DreamerV3 through its CLI on the CPU, at a
tiny width on the dummy env: an exploration run (every module, optimizer
and ``Moments`` state in its checkpoint), finetuning from its checkpoint
(the exploration run's env keys and model settings handed over, the actor
switch at ``learning_starts``, the exploration buffer loaded), finetuning
from a JAX exploration checkpoint (written by the JAX package's own writer),
and the eval builder's choice of the task actor in both phases'
checkpoints."""

import gymnasium as gym
import jax
import numpy as np
import pytest

from sheeprl_tpu.algos.dreamer_v3.utils import init_moments as jax_init_moments
from sheeprl_tpu.algos.p2e_dv3 import agent as jax_agent
from sheeprl_tpu.ckpt.writer import write_checkpoint as jax_write_checkpoint
from sheeprl_tpu.config import compose
from sheeprl_tpu.utils.utils import save_configs as jax_save_configs
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.ckpt import read_checkpoint, validate_checkpoint
from sheeprl_tpu_torch.convert import convert_p2e_dv3
from sheeprl_tpu_torch.evals.builders import serving_params

CRITICS = ("intrinsic", "extrinsic")

TINY = [
    "env=dummy", "env.id=discrete_dummy", "env.num_envs=2", "env.sync_env=True", "env.capture_video=False",
    "fabric.accelerator=cpu", "metric.log_level=0", "buffer.memmap=False", "checkpoint.every=1000000",
    "per_rank_batch_size=2", "per_rank_sequence_length=4", "algo.horizon=2", "algo.dense_units=8",
    "algo.mlp_layers=1", "algo.world_model.encoder.cnn_channels_multiplier=2",
    "algo.world_model.recurrent_model.recurrent_state_size=8", "algo.world_model.transition_model.hidden_size=8",
    "algo.world_model.representation_model.hidden_size=8", "algo.world_model.stochastic_size=4",
    "algo.world_model.discrete_size=4", "algo.ensembles.n=3", "cnn_keys.encoder=[rgb]", "algo.train_every=2",
]


@pytest.fixture(scope="module")
def exploration_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("p2e_dv3")
    result = cli.run(TINY + ["exp=p2e_dv3_exploration", "total_steps=24", "algo.learning_starts=12",
                             "buffer.size=64", "buffer.checkpoint=True", f"root_dir={root}", "run_name=expl"])
    return root, result


def test_exploration_run_writes_every_module(exploration_run):
    _root, result = exploration_run
    assert result["gradient_steps"] == 7 and result["random_steps"] == 6 and result["player_steps"] == 6
    assert result["player_steps_by_actor"] == [6] and result["actor_switched_at"] is None
    assert result["test_steps"] > 0
    validate_checkpoint(result["checkpoint"])
    agent = read_checkpoint(result["checkpoint"], with_rb=False)["agent"]
    assert set(agent) == {"world_model", "actor_task", "critic_task", "target_critic_task", "actor_exploration",
                          "critics_exploration", "ensembles", "opt", "moments"}
    assert set(agent["critics_exploration"]) == set(CRITICS)
    assert set(agent["opt"]) == {"world_model", "ensembles", "actor_task", "critic_task", "actor_exploration",
                                 "critics_exploration"}
    assert set(agent["moments"]["exploration"]) == set(CRITICS)
    assert agent["ensembles"]["head.weight"].shape == (3, 8, 16)


def test_exploration_resumes_from_its_checkpoint(exploration_run):
    """``checkpoint.resume_from`` an exploration checkpoint (its buffer
    with it): every module, optimizer and ``Moments`` state reloads, the run
    carries on from the checkpoint's update with the exploration actor and
    no random prefill."""
    root, expl = exploration_run
    result = cli.run(TINY + ["exp=p2e_dv3_exploration", "total_steps=32", "algo.learning_starts=12", "buffer.size=64",
                             "buffer.checkpoint=True", f"checkpoint.resume_from={expl['checkpoint']}",
                             f"root_dir={root}", "run_name=resumed"])
    assert (result["updates"], result["random_steps"], result["gradient_steps"]) == (5, 0, 5)
    assert result["player_steps_by_actor"] == [5]
    validate_checkpoint(result["checkpoint"])


def test_finetuning_from_the_port_exploration_switches_actors(exploration_run):
    """``exp=p2e_dv3_finetuning`` from the exploration checkpoint: the env
    keys come from the exploration run (a different ``env.id`` raises), the
    run acts with the exploration actor from its first step and with the
    task actor from ``learning_starts``, and its checkpoint holds the task
    agent with the frozen exploration actor beside it."""
    root, expl = exploration_run
    base = TINY + ["exp=p2e_dv3_finetuning", f"checkpoint.exploration_ckpt_path={expl['checkpoint']}",
                   "total_steps=20", "algo.learning_starts=12", "buffer.size=64", f"root_dir={root}"]
    with pytest.raises(ValueError, match="different environment"):
        cli.run([o for o in base if not o.startswith("env.id=")] + ["env.id=continuous_dummy", "run_name=bad"])
    result = cli.run(base + ["run_name=fntn", "env.screen_size=32"])
    assert result["random_steps"] == 0 and result["player_steps"] == 10
    assert result["player_steps_by_actor"] == [5, 5] and result["actor_switched_at"] == 6
    assert result["gradient_steps"] == 5
    validate_checkpoint(result["checkpoint"])
    ckpt = read_checkpoint(result["checkpoint"], with_rb=False)
    assert set(ckpt["agent"]) == {"world_model", "actor", "critic", "target_critic", "opt", "moments"}
    expl_agent = read_checkpoint(expl["checkpoint"], with_rb=False)["agent"]
    for k, v in ckpt["actor_exploration"].items():
        np.testing.assert_array_equal(v, expl_agent["actor_exploration"][k])
    # the exploration run's screen (64) came across, not this command's
    cfg, _ = cli.load_run_config(result["checkpoint"])
    assert int(cfg.env.screen_size) == 64 and cfg.algo.name == "p2e_dv3_finetuning"


def test_finetuning_loads_the_exploration_buffer(exploration_run):
    root, expl = exploration_run
    result = cli.run(TINY + ["exp=p2e_dv3_finetuning", f"checkpoint.exploration_ckpt_path={expl['checkpoint']}",
                             "total_steps=4", "algo.learning_starts=0", "buffer.size=64",
                             "buffer.load_from_exploration=True", f"root_dir={root}", "run_name=fntn_rb"])
    # with the exploration buffer there is data to sample from the first step
    assert result["gradient_steps"] == 2 and result["player_steps_by_actor"] == [0, 2]


def test_eval_builder_picks_the_task_actor(exploration_run):
    _root, expl = exploration_run
    state = read_checkpoint(expl["checkpoint"], with_rb=False)
    params = serving_params(state, "p2e_dv3_exploration")
    assert set(params) == {"world_model", "actor"}
    for k, v in params["actor"].items():
        np.testing.assert_array_equal(v.numpy(), state["agent"]["actor_task"][k])
    fntn = {"agent": {"world_model": state["agent"]["world_model"], "actor": state["agent"]["actor_exploration"]},
            "actor_exploration": state["agent"]["actor_task"]}
    for k, v in serving_params(fntn, "p2e_dv3_finetuning")["actor"].items():
        np.testing.assert_array_equal(v.numpy(), state["agent"]["actor_exploration"][k])
    result = cli.evaluation([f"checkpoint_path={expl['checkpoint']}", "fabric.accelerator=cpu", "eval.episodes=2",
                             "eval.write_registry=False"])
    assert result["n"] == 2 and result["algo"] == "p2e_dv3_exploration"


@pytest.fixture(scope="module")
def jax_exploration_run(tmp_path_factory):
    """A JAX P2E-DV3 exploration checkpoint at the tiny width, written by the
    JAX package's own writer beside its persisted config: the JAX
    ``build_agent``'s params and ``Moments`` states off zero (the optimizer
    state, which finetuning does not read, left out)."""
    log_dir = tmp_path_factory.mktemp("jax_p2e_dv3") / "jax" / "version_0"
    jcfg = compose(overrides=[o for o in TINY if o != "fabric.accelerator=cpu"] + ["exp=p2e_dv3_exploration"])
    space = gym.spaces.Dict({"rgb": gym.spaces.Box(0, 255, (3, 64, 64), np.uint8)})
    *_, params = jax_agent.build_agent(jcfg, (2,), False, space, jax.random.PRNGKey(5))
    moments = {"task": {"low": np.float32(-0.25), "high": np.float32(1.5)},
               "exploration": {k: jax_init_moments() for k in CRITICS}}
    state = {"agent": {"params": jax.device_get(params), "moments": jax.device_get(moments)},
             "expl_decay_steps": 3, "update": 8, "batch_size": 2, "last_log": 0, "last_checkpoint": 16}
    jax_save_configs(jcfg, str(log_dir))
    ckpt = str(log_dir / "checkpoint" / "ckpt_16_0")
    jax_write_checkpoint(ckpt, state, step=16, algo="p2e_dv3_exploration")
    return ckpt


def test_finetuning_from_a_jax_exploration_checkpoint(jax_exploration_run, tmp_path):
    """The port finetunes from the JAX package's exploration checkpoint: the
    world model, the task actor, critic and target, the task ``Moments`` and
    the exploration actor converted and carried over. The run acts with the
    exploration actor and takes no gradient step before its checkpoint, so
    that every tree still equals the converted JAX one."""
    result = cli.run(TINY + ["exp=p2e_dv3_finetuning", f"checkpoint.exploration_ckpt_path={jax_exploration_run}",
                             "total_steps=8", "algo.learning_starts=100", "buffer.size=64", f"root_dir={tmp_path}",
                             "run_name=fntn_jax"])
    assert result["player_steps_by_actor"] == [4, 0] and result["gradient_steps"] == 0
    jax_state = read_checkpoint(jax_exploration_run, with_rb=False)
    converted, _ = convert_p2e_dv3(jax_state["agent"]["params"], training=True)
    ckpt = read_checkpoint(result["checkpoint"], with_rb=False)
    pairs = {"world_model": "world_model", "actor": "actor_task", "critic": "critic_task",
             "target_critic": "target_critic_task"}
    for name, jax_name in pairs.items():
        for k, v in converted[jax_name].items():
            np.testing.assert_array_equal(ckpt["agent"][name][k], v.numpy(), err_msg=f"{name}.{k}")
    for k, v in converted["actor_exploration"].items():
        np.testing.assert_array_equal(ckpt["actor_exploration"][k], v.numpy())
    assert float(ckpt["agent"]["moments"]["low"]) == -0.25 and float(ckpt["agent"]["moments"]["high"]) == 1.5
    assert int(ckpt["expl_decay_steps"]) == 3

"""DreamerV3's L and XL presets and P2E-DV3's L DIAMBRA presets in the port,
against the JAX package on the CPU.

- Each preset composes in the port to the JAX package's widths.
- ``convert_dreamer_v3`` carries every leaf of a JAX build at the L width
  (the ``dreamer_v3_L_doapp`` preset as it ships, on the DIAMBRA stand-in's
  spaces): the JAX tree's shapes from ``jax.eval_shape``, zeros of those
  shapes converted and loaded strictly into the port's training build.
- ``chip_smoke.py`` runs these presets through the port's own DIAMBRA and
  Crafter wrappers over the stand-in simulators of ``tests/sim_stubs.py``
  (the card has no diambra or crafter): over the same stand-in, the port's
  wrapper and the JAX wrapper have the same spaces key by key (shape,
  dtype, bounds) and the same action space.
- The port's CLI runs each preset end to end at a reduced width through its
  own wrapper over the stand-ins, at its own precision (f32 for the DreamerV3 presets, bf16-mixed
  for the P2E ones; finetuning from the exploration run's checkpoint) and
  the L preset also under bf16-mixed: every floating array of each
  checkpoint's agent is f32.
"""

import importlib

import gymnasium as gym
import jax
import numpy as np
import pytest
import sim_stubs
import torch
from test_torch_envs_sims import _same, sims  # noqa: F401  (sims: the stand-in simulators fixture)

import chip_smoke
from sheeprl_tpu.algos.dreamer_v3 import agent as jax_agent
from sheeprl_tpu.config import compose
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
from sheeprl_tpu_torch.ckpt import read_checkpoint
from sheeprl_tpu_torch.config import compose as port_compose
from sheeprl_tpu_torch.convert import convert_dreamer_v3

PRESETS = (
    "dreamer_v3_L_doapp",
    "dreamer_v3_L_doapp_128px_gray_combo_discrete",
    "dreamer_v3_L_navigate",
    "dreamer_v3_XL_crafter",
    "p2e_dv3_expl_L_doapp_128px_gray_combo_discrete_15Mexpl_20Mstps",
    "p2e_dv3_fntn_L_doapp_64px_gray_combo_discrete_5Mstps",
)
WIDTHS = (
    "algo.dense_units", "algo.mlp_layers", "algo.world_model.encoder.cnn_channels_multiplier",
    "algo.world_model.encoder.dense_units", "algo.world_model.encoder.mlp_layers",
    "algo.world_model.recurrent_model.recurrent_state_size", "algo.world_model.recurrent_model.dense_units",
    "algo.world_model.transition_model.hidden_size", "algo.world_model.representation_model.hidden_size",
    "algo.world_model.stochastic_size", "algo.world_model.discrete_size", "algo.world_model.reward_model.bins",
    "algo.world_model.observation_model.mlp_layers", "algo.actor.dense_units", "algo.actor.mlp_layers",
    "algo.critic.dense_units", "algo.critic.mlp_layers", "env.screen_size", "env.num_envs", "env.grayscale",
    "per_rank_batch_size", "per_rank_sequence_length", "fabric.precision",
)


def _get(cfg, dotted):
    for part in dotted.split("."):
        cfg = cfg[part]
    return cfg


@pytest.mark.parametrize("exp", PRESETS)
def test_presets_compose_to_the_jax_widths(exp):
    extra = ["checkpoint.exploration_ckpt_path=/nowhere"] if "fntn" in exp else []
    port = port_compose(overrides=[f"exp={exp}"] + extra)
    jcfg = compose(overrides=[f"exp={exp}"] + extra)
    for key in WIDTHS:
        assert _get(port, key) == _get(jcfg, key), key
    assert list(port.cnn_keys.encoder) == list(jcfg.cnn_keys.encoder)
    assert list(port.mlp_keys.encoder) == list(jcfg.mlp_keys.encoder)
    large = {"L": (2048, 768), "XL": (4096, 1024)}["XL" if "XL" in exp else "L"]
    if exp.startswith("p2e"):
        large = (1024, 768)
        assert port.fabric.precision == "bf16-mixed"
    assert (port.algo.world_model.recurrent_model.recurrent_state_size, port.algo.dense_units) == large


def test_converter_carries_every_leaf_of_a_jax_build_at_L_width():
    """The shipped ``dreamer_v3_L_doapp`` widths (recurrent 2048, dense 768 x
    4, CNN multiplier 64) on the DIAMBRA stand-in's keys: every leaf of the
    JAX training build (its shapes from ``jax.eval_shape``: no L-sized
    initialization runs) converts, none is skipped, and the port's training
    build loads the result strictly, shape for shape."""
    exp = "dreamer_v3_L_doapp"
    jcfg = compose(overrides=[f"exp={exp}"])
    space = gym.spaces.Dict({k: gym.spaces.Box(0, 255, shape, np.uint8) if len(shape) == 3
                             else gym.spaces.Box(-np.inf, np.inf, shape, np.float32)
                             for k, shape in chip_smoke.DOAPP_L_OBS.items()})
    actions = (chip_smoke.DOAPP_ACTIONS,)
    shapes = jax.eval_shape(lambda k: jax_agent.build_agent(jcfg, actions, False, space, k)[3], jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    state_dicts, skipped = convert_dreamer_v3(zeros, training=True)
    assert skipped == []
    cfg = port_compose(overrides=[f"exp={exp}", "algo.hafner_initialization=False"])
    modules = build_agent(cfg, actions, False, chip_smoke.DOAPP_L_OBS, device="cpu", training=True)
    n_leaves = 0
    for name, module in zip(("world_model", "actor", "critic", "target_critic"), modules):
        module.load_state_dict(state_dicts[name], strict=True)
        n_leaves += len(state_dicts[name])
        assert all(p.dtype == torch.float32 for p in module.parameters())
    assert n_leaves == len(jax.tree_util.tree_leaves(shapes))
    assert modules[0].rssm.recurrent_model.gru.weight.shape == (768 + 2048, 3 * 2048)


def _wrappers(name):
    """The JAX package's and the port's ``envs.<name>`` modules, imported over the stand-ins."""
    return (importlib.import_module(f"sheeprl_tpu.envs.{name}"),
            importlib.import_module(f"sheeprl_tpu_torch.envs.{name}"))


def _assert_same_spaces(port_env, jax_env):
    port_spaces, jax_spaces = port_env.observation_space.spaces, jax_env.observation_space.spaces
    assert set(port_spaces) == set(jax_spaces)
    for k, want in jax_spaces.items():
        got = port_spaces[k]
        assert got.shape == want.shape and np.dtype(got.dtype) == np.dtype(want.dtype), k
        np.testing.assert_array_equal(np.broadcast_to(got.low, got.shape), want.low, err_msg=k)
        np.testing.assert_array_equal(np.broadcast_to(got.high, got.shape), want.high, err_msg=k)
    assert port_env.action_space.n == jax_env.action_space.n


@pytest.mark.parametrize("grayscale", [False, True], ids=["rgb", "grey"])
def test_doapp_stand_in_has_the_jax_diambra_wrappers_spaces(sims, grayscale):
    """Dead or Alive++ at the presets' settings (64 px, RGB or grey, no role), through the port's and the JAX
    DIAMBRA wrapper over the diambra stand-in: the same spaces and the same first observation; an action outside
    the combo-discrete space raises."""
    jax_module, port_module = _wrappers("diambra")
    kwargs = dict(screen_size=64, grayscale=grayscale, rank=0, diambra_settings={"role": None},
                  diambra_wrappers={})
    jax_env = jax_module.DiambraWrapper("doapp", **kwargs)
    port_env = port_module.DiambraWrapper("doapp", **kwargs)
    _assert_same_spaces(port_env, jax_env)
    _same(jax_env.reset(seed=1)[0], port_env.reset(seed=1)[0], "reset")
    _obs, _r, terminated, truncated, _ = port_env.step(np.asarray([chip_smoke.DOAPP_ACTIONS - 1]))
    assert not terminated and not truncated
    with pytest.raises(ValueError):
        port_env.step(chip_smoke.DOAPP_ACTIONS)


def test_crafter_stand_in_has_the_jax_crafter_wrappers_spaces(sims):
    """Crafter through the port's and the JAX Crafter wrapper over the crafter stand-in; its episode (a life)
    ends after ``sim_stubs.EPISODE_STEPS`` steps."""
    jax_module, port_module = _wrappers("crafter")
    jax_env = jax_module.CrafterWrapper("crafter_reward", screen_size=64, seed=0)
    port_env = port_module.CrafterWrapper("crafter_reward", screen_size=64, seed=0)
    _assert_same_spaces(port_env, jax_env)
    port_env.reset(seed=2)
    for t in range(sim_stubs.EPISODE_STEPS):
        _obs, _r, terminated, _trunc, _ = port_env.step(3)
    assert terminated and t == sim_stubs.EPISODE_STEPS - 1


SMALL = [
    "algo.dense_units=8", "algo.mlp_layers=1", "algo.world_model.encoder.cnn_channels_multiplier=2",
    "algo.world_model.recurrent_model.recurrent_state_size=8", "algo.world_model.transition_model.hidden_size=8",
    "algo.world_model.representation_model.hidden_size=8", "algo.world_model.stochastic_size=4",
    "algo.world_model.discrete_size=4", "algo.horizon=3", "per_rank_sequence_length=8", "per_rank_batch_size=2",
    "fabric.accelerator=cpu", "env.sync_env=True", "env.capture_video=False", "buffer.size=512",
    "metric.log_level=0", "algo.ensembles.n=2",
]
# (exp, extra overrides: learning from 8 steps an env, 3 bursts after it). The XL preset's env.id "reward" is no
# Crafter id the wrappers take (the JAX one raises on it too): its run names its task, crafter_reward
RUNS = {
    "L": ("dreamer_v3_L_doapp", ["algo.learning_starts=64", "total_steps=88"]),
    "L_bf16": ("dreamer_v3_L_doapp", ["algo.learning_starts=64", "total_steps=88", "fabric.precision=bf16-mixed"]),
    "L_128px": ("dreamer_v3_L_doapp_128px_gray_combo_discrete",
                ["algo.learning_starts=64", "total_steps=88", "env.num_envs=8"]),
    "XL": ("dreamer_v3_XL_crafter", ["algo.learning_starts=16", "total_steps=22", "env.id=crafter_reward"]),
}


def _f32_agent(ckpt):
    floats = []

    def walk(node):
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, np.ndarray) and np.issubdtype(node.dtype, np.floating):
            floats.append(node.dtype)

    walk(read_checkpoint(ckpt, with_rb=False)["agent"])
    assert floats and set(floats) == {np.dtype(np.float32)}


def _run(tmp_path, name, exp, extra):
    """The preset through the port's CLI and its own env.wrapper over the stand-in simulators."""
    args = [f"exp={exp}", f"root_dir={tmp_path}", f"run_name={name}"] + SMALL + extra
    if not exp.startswith("p2e"):
        args.remove("algo.ensembles.n=2")
    result = cli.run(args)
    assert result["gradient_steps"] >= 3 and result["test_steps"] == sim_stubs.EPISODE_STEPS
    _f32_agent(result["checkpoint"])
    return result


@pytest.mark.parametrize("name", sorted(RUNS))
def test_cli_runs_the_preset_on_its_stand_in(sims, tmp_path, name):
    _run(tmp_path, name, *RUNS[name])


def test_cli_runs_the_p2e_L_presets_under_bf16(sims, tmp_path):
    """Exploration, then finetuning from its checkpoint, each at its preset's
    ``bf16-mixed``; the finetuning player switches to the task actor."""
    steps = ["algo.learning_starts=128", "total_steps=176"]
    expl = _run(tmp_path, "expl", "p2e_dv3_expl_L_doapp_128px_gray_combo_discrete_15Mexpl_20Mstps", steps)
    fntn = _run(tmp_path, "fntn", "p2e_dv3_fntn_L_doapp_64px_gray_combo_discrete_5Mstps",
                steps + [f"checkpoint.exploration_ckpt_path={expl['checkpoint']}"])
    assert fntn["actor_switched_at"] == 128 // 16

"""DreamerV3's L and XL presets and P2E-DV3's L DIAMBRA presets in the port,
against the JAX package on the CPU.

- Each preset composes in the port to the JAX package's widths.
- ``convert_dreamer_v3`` carries every leaf of a JAX build at the L width
  (the ``dreamer_v3_L_doapp`` preset as it ships, on the DIAMBRA stand-in's
  spaces): the JAX tree's shapes from ``jax.eval_shape``, zeros of those
  shapes converted and loaded strictly into the port's training build.
- The stand-in envs that ``chip_smoke.py`` runs these presets on (the card
  has no diambra or crafter) have the JAX wrappers' spaces: each JAX wrapper
  is built over a stub simulator module put into ``sys.modules`` that gives
  the raw spaces the stand-in starts from, and the two are compared key by
  key (shape, dtype, bounds) with the action space.
- The port's CLI runs each preset end to end at a reduced width on the
  stand-ins, at its own precision (f32 for the DreamerV3 presets, bf16-mixed
  for the P2E ones; finetuning from the exploration run's checkpoint) and
  the L preset also under bf16-mixed: every floating array of each
  checkpoint's agent is f32.
"""

import importlib
import sys
import types

import gymnasium as gym
import jax
import numpy as np
import pytest
import torch

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


def _gym_space(kind, *args):
    if kind == "discrete":
        return gym.spaces.Discrete(args[0])
    return gym.spaces.Box(args[0], args[1], (1,), np.int32)


def _stub_diambra(monkeypatch):
    """A ``diambra``/``diambra.arena`` stub whose ``make`` gives an env of the
    raw Dead or Alive++ spaces the stand-in starts from (``DOAPP_RAW_KEYS``;
    the frame at the settings' ``frame_shape``, 0 channels meaning RGB, as
    the engine reads it) and the combo-discrete action space."""
    diambra, arena = types.ModuleType("diambra"), types.ModuleType("diambra.arena")

    class SpaceTypes:
        DISCRETE, MULTI_DISCRETE = "DISCRETE", "MULTI_DISCRETE"

    class Settings:
        def __init__(self, **kwargs):
            self.__dict__.update(kwargs)

    class Env(gym.Env):
        def __init__(self, settings):
            h, w, c = settings.frame_shape
            frame = gym.spaces.Box(0, 255, (h, w, 1 if c == 1 else 3), np.uint8)
            raw = {k: _gym_space(*v) for k, v in chip_smoke.DOAPP_RAW_KEYS.items()}
            self.observation_space = gym.spaces.Dict({"frame": frame, **raw})
            self.action_space = gym.spaces.Discrete(chip_smoke.DOAPP_ACTIONS)

    arena.SpaceTypes, arena.EnvironmentSettings, arena.WrappersSettings = SpaceTypes, Settings, Settings
    arena.make = lambda id, settings, wrappers, **kwargs: Env(settings)
    diambra.arena = arena
    monkeypatch.setitem(sys.modules, "diambra", diambra)
    monkeypatch.setitem(sys.modules, "diambra.arena", arena)


def _stub_crafter(monkeypatch):
    crafter = types.ModuleType("crafter")

    class Env(gym.Env):
        def __init__(self, size, seed=None, reward=True):
            self.observation_space = gym.spaces.Box(0, 255, tuple(size) + (3,), np.uint8)
            self.action_space = gym.spaces.Discrete(chip_smoke.CRAFTER_ACTIONS)
            self.reward_range = None

    crafter.Env = Env
    monkeypatch.setitem(sys.modules, "crafter", crafter)


def _jax_wrapper_module(monkeypatch, name, flags):
    """``sheeprl_tpu.envs.<name>`` imported afresh over the stubs (its import
    gate reads the flags of ``sheeprl_tpu.utils.imports``)."""
    imports = importlib.import_module("sheeprl_tpu.utils.imports")
    for flag in flags:
        monkeypatch.setattr(imports, flag, True)
    monkeypatch.delitem(sys.modules, f"sheeprl_tpu.envs.{name}", raising=False)
    return importlib.import_module(f"sheeprl_tpu.envs.{name}")


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
def test_doapp_stand_in_has_the_jax_diambra_wrappers_spaces(monkeypatch, grayscale):
    _stub_diambra(monkeypatch)
    module = _jax_wrapper_module(monkeypatch, "diambra", ("_IS_DIAMBRA_AVAILABLE", "_IS_DIAMBRA_ARENA_AVAILABLE"))
    jax_env = module.DiambraWrapper("doapp", screen_size=64, grayscale=grayscale,
                                    diambra_settings={"role": None}, diambra_wrappers={})
    port_env = chip_smoke.doapp_stand_in("doapp", screen_size=64, grayscale=grayscale, rank=0)
    _assert_same_spaces(port_env, jax_env)
    obs, _ = port_env.reset(seed=1)
    for k, v in obs.items():
        assert jax_env.observation_space[k].contains(v), k
    _obs, _r, terminated, truncated, _ = port_env.step(np.asarray([chip_smoke.DOAPP_ACTIONS - 1]))
    assert not terminated and not truncated
    with pytest.raises(ValueError):
        port_env.step(chip_smoke.DOAPP_ACTIONS)


def test_crafter_stand_in_has_the_jax_crafter_wrappers_spaces(monkeypatch):
    _stub_crafter(monkeypatch)
    module = _jax_wrapper_module(monkeypatch, "crafter", ("_IS_CRAFTER_AVAILABLE",))
    jax_env = module.CrafterWrapper("crafter_reward", screen_size=64, seed=0)
    port_env = chip_smoke.crafter_stand_in("crafter_reward", screen_size=64, seed=0)
    _assert_same_spaces(port_env, jax_env)
    port_env.reset(seed=2)
    for t in range(chip_smoke.STAND_IN_EPISODE):
        _obs, _r, terminated, _trunc, _ = port_env.step(3)
    assert terminated and t == chip_smoke.STAND_IN_EPISODE - 1


SMALL = [
    "algo.dense_units=8", "algo.mlp_layers=1", "algo.world_model.encoder.cnn_channels_multiplier=2",
    "algo.world_model.recurrent_model.recurrent_state_size=8", "algo.world_model.transition_model.hidden_size=8",
    "algo.world_model.representation_model.hidden_size=8", "algo.world_model.stochastic_size=4",
    "algo.world_model.discrete_size=4", "algo.horizon=3", "per_rank_sequence_length=8", "per_rank_batch_size=2",
    "fabric.accelerator=cpu", "env.sync_env=True", "env.capture_video=False", "buffer.size=512",
    "metric.log_level=0", "algo.ensembles.n=2",
]
# (exp, stand-in, extra overrides: learning from 8 steps an env, 3 bursts after it)
RUNS = {
    "L": ("dreamer_v3_L_doapp", "doapp", ["algo.learning_starts=64", "total_steps=88"]),
    "L_bf16": ("dreamer_v3_L_doapp", "doapp", ["algo.learning_starts=64", "total_steps=88",
                                               "fabric.precision=bf16-mixed"]),
    "L_128px": ("dreamer_v3_L_doapp_128px_gray_combo_discrete", "doapp",
                ["algo.learning_starts=64", "total_steps=88", "env.num_envs=8"]),
    "XL": ("dreamer_v3_XL_crafter", "crafter", ["algo.learning_starts=16", "total_steps=22"]),
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


def _run(tmp_path, name, exp, env, extra):
    args = [f"exp={exp}", f"env.wrapper._target_=chip_smoke.{env}_stand_in", f"root_dir={tmp_path}",
            f"run_name={name}"] + SMALL + extra
    if not exp.startswith("p2e"):
        args.remove("algo.ensembles.n=2")
    result = cli.run(args)
    assert result["gradient_steps"] >= 3 and result["test_steps"] == chip_smoke.STAND_IN_EPISODE
    _f32_agent(result["checkpoint"])
    return result


@pytest.mark.parametrize("name", sorted(RUNS))
def test_cli_runs_the_preset_on_its_stand_in(tmp_path, name):
    _run(tmp_path, name, *RUNS[name])


def test_cli_runs_the_p2e_L_presets_under_bf16(tmp_path):
    """Exploration, then finetuning from its checkpoint, each at its preset's
    ``bf16-mixed``; the finetuning player switches to the task actor."""
    steps = ["algo.learning_starts=128", "total_steps=176"]
    expl = _run(tmp_path, "expl", "p2e_dv3_expl_L_doapp_128px_gray_combo_discrete_15Mexpl_20Mstps", "doapp", steps)
    fntn = _run(tmp_path, "fntn", "p2e_dv3_fntn_L_doapp_64px_gray_combo_discrete_5Mstps", "doapp",
                steps + [f"checkpoint.exploration_ckpt_path={expl['checkpoint']}"])
    assert fntn["actor_switched_at"] == 128 // 16

"""The port's DreamerV3 builds against the JAX package's on the CPU: the
Hafner initialization on statistics (the PRNG streams differ), and the
converter on a full-width ``exp=dreamer_v3_100k_ms_pacman`` tree.

Tolerances: on leaves of at least 10,000 elements each weight's standard
deviation within 3% (the port's, a fixed draw) and 5% (the JAX leaf's) of
the scheme's ``sqrt(1/fan mean)``; every weight inside the cut normal's
bound; zeros, biases and LayerNorm affine exact; converted trees load
strictly, every leaf consumed.
"""

import gymnasium as gym
import jax
import numpy as np
import pytest
import torch
from jax_jit_build import jit_build

from sheeprl_tpu.algos.dreamer_v3 import agent as jax_agent
from sheeprl_tpu.config import compose
from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
from sheeprl_tpu_torch.configs import dreamer_v3_config
from sheeprl_tpu_torch.convert import convert_dreamer_v3

ACTIONS = (9,)
MODULES = ("world_model", "actor", "critic", "target_critic")
SMALL = {
    "algo.mlp_layers": 2,
    "algo.world_model.encoder.cnn_channels_multiplier": 4,
    "algo.world_model.stochastic_size": 4,
    "algo.world_model.discrete_size": 5,
    "cnn_keys.encoder": ["rgb"],
    "mlp_keys.encoder": ["state"],
    "cnn_keys.decoder": ["rgb"],
    "mlp_keys.decoder": ["state"],
}
OBS = {"rgb": (3, 64, 64), "state": (7,)}


def _jax_space():
    return gym.spaces.Dict({
        "rgb": gym.spaces.Box(0, 255, (3, 64, 64), np.uint8),
        "state": gym.spaces.Box(-10, 10, (7,), np.float32),
    })


def _jax_cfg(overrides, exp="dreamer_v3_100k_ms_pacman"):
    return compose(overrides=[f"exp={exp}", "env=dummy"] + [f"{k}={v}" for k, v in overrides.items()])


def test_hafner_initialization_matches_jax_statistics():
    """Every weight of a training build against the JAX build's leaf at the
    same shape. Both schemes give a weight of fan mean ``m`` the std
    ``sqrt(1/m)``: a normal cut at ±2 of its own std, or a uniform on
    ``±sqrt(3/m)`` for the heads, and zeros where the scale is 0. So: zero
    leaves zero on both sides; every other weight inside ``2/0.8796·sqrt(1/m)``;
    on leaves of at least 10,000 elements the port's std within 3% and the
    JAX leaf's within 5% of ``sqrt(1/m)`` (the JAX draw depends on its PRNG
    configuration), and the same scheme on both sides (max/std about 1.73
    for a uniform, 2.27 for the cut normal); biases and LayerNorm affine
    exact; the target critic equal to the critic."""
    overrides = {**SMALL, "algo.dense_units": 128, "algo.world_model.recurrent_model.recurrent_state_size": 128,
                 "algo.world_model.transition_model.hidden_size": 128,
                 "algo.world_model.representation_model.hidden_size": 128}
    jcfg = _jax_cfg(overrides)
    params = jax.device_get(jit_build(jax_agent.build_agent, jcfg, ACTIONS, False, _jax_space(), jax.random.PRNGKey(0))[3])
    want, _ = convert_dreamer_v3(params, training=True)
    modules = build_agent(dreamer_v3_config(**overrides), ACTIONS, False, OBS, seed=1, device="cpu", training=True)
    compared = 0
    for name, module in zip(MODULES, modules):
        got = module.state_dict()
        assert got.keys() == want[name].keys()
        for key, value in got.items():
            theirs = want[name][key]
            assert value.shape == theirs.shape, key
            if not key.endswith("weight") or value.dim() < 2:  # biases and LayerNorm affine: exact
                torch.testing.assert_close(value, theirs, rtol=0, atol=0, msg=f"{name}.{key}")
                continue
            if theirs.abs().max() == 0:
                assert value.abs().max() == 0, f"{name}.{key} should be zeros"
                continue
            fan_mean = (value.shape[0] + value.shape[1]) * int(np.prod(value.shape[2:])) / 2.0
            std = (1.0 / fan_mean) ** 0.5
            assert value.abs().max() <= 2.0 / 0.87962566103423978 * std * (1 + 1e-6), f"{name}.{key} out of bound"
            if value.numel() >= 10_000:
                assert abs(float(value.std()) / std - 1.0) < 0.03, f"{name}.{key}: std {float(value.std())} vs {std}"
                assert abs(float(theirs.std()) / std - 1.0) < 0.05, f"JAX {name}.{key}: std {float(theirs.std())}"
                uniform = [float(t.abs().max() / t.std()) < 2.0 for t in (value, theirs)]
                assert uniform[0] == uniform[1], f"{name}.{key}: uniform in the port {uniform[0]}, in JAX {uniform[1]}"
                compared += 1
    assert compared >= 10
    torch.testing.assert_close(modules[2].state_dict(), modules[3].state_dict(), rtol=0, atol=0)


def test_converter_consumes_every_leaf_of_a_full_width_tree():
    """A full ``exp=dreamer_v3_100k_ms_pacman`` tree (world model with
    decoders and heads, actor, critic, target critic): every leaf is
    converted, and every state dict loads strictly into a full-width
    training build of the port."""
    jcfg = compose(overrides=["exp=dreamer_v3_100k_ms_pacman", "env=dummy"])
    space = gym.spaces.Dict({"rgb": gym.spaces.Box(0, 255, (3, 64, 64), np.uint8)})
    params = jax.device_get(jit_build(jax_agent.build_agent, jcfg, ACTIONS, False, space, jax.random.PRNGKey(0))[3])
    state_dicts, skipped = convert_dreamer_v3(params, training=True)
    assert skipped == []
    assert sorted(state_dicts) == sorted(MODULES)
    modules = build_agent(dreamer_v3_config(), ACTIONS, False, {"rgb": (3, 64, 64)}, device="cpu", training=True)
    assert modules[0].rssm.recurrent_model.gru.weight.shape == (1024, 1536)  # H = X = 512, no bias
    assert modules[0].rssm.recurrent_model.gru.bias is None
    for name, module in zip(MODULES, modules):
        assert len(state_dicts[name]) == len(jax.tree_util.tree_leaves(params[name])), name
        module.load_state_dict(state_dicts[name])
        assert sum(p.numel() for p in module.state_dict().values()) == sum(
            np.asarray(a).size for a in jax.tree_util.tree_leaves(params[name])
        )
    params["critic"]["mystery"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="mystery"):
        convert_dreamer_v3(params, training=True)

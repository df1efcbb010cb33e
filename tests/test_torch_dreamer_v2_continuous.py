"""The port's continuous-action DreamerV2 training step against the JAX
package on the CPU.

One whole gradient step of each side at a small width on a 2-wide Box of
actions (the continuous dummy env's), from the same weights, batch and
noise. The actor mixes REINFORCE and dynamics backprop half and half
(``algo.actor.objective_mix=0.5``), so both terms and the gradient through
the imagination are live. The JAX step draws its noise inside the jitted
program; the test re-derives it with JAX's own key schedule (``fold_in`` of
the data-axis index, ``split`` into the world-model and imagination keys;
the posterior Gumbels; ``split`` into the prior Gumbels' key and the step
keys; each step's key split once for the single continuous head, its
uniforms on ``[1e-6, 1 − 1e-6]`` drawn from it).

Tolerances (float32 on the CPU; XLA and PyTorch sum in different orders),
as ``test_torch_dreamer_v2_train.py`` states them: losses and metrics rtol
1e-4, atol 1e-6; gradients per module (the optimizers' first moments over
``1 − β1``) rtol 1e-3, atol 1e-5; updated parameters atol 2e-6.
"""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v2 import agent as jax_agent
from sheeprl_tpu.algos.dreamer_v2 import dreamer_v2 as jax_dv2
from sheeprl_tpu.config import compose
from sheeprl_tpu.fabric import Fabric
from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_agent
from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import build_optimizers_and_state, build_train_fn
from sheeprl_tpu_torch.configs import dreamer_v2_config
from sheeprl_tpu_torch.convert import convert_dreamer_v2

SMALL = {
    "algo.dense_units": 16,
    "algo.mlp_layers": 2,
    "algo.world_model.encoder.cnn_channels_multiplier": 2,
    "algo.world_model.recurrent_model.recurrent_state_size": 32,
    "algo.world_model.stochastic_size": 4,
    "algo.world_model.discrete_size": 4,
    "algo.world_model.transition_model.hidden_size": 16,
    "algo.world_model.representation_model.hidden_size": 16,
    "algo.horizon": 3,
    "algo.actor.objective_mix": 0.5,
    "per_rank_batch_size": 3,
    "per_rank_sequence_length": 4,
}
T, B, HORIZON, S, D = 4, 3, 3, 4, 4
ACTIONS = (2,)
METRIC_TOL = dict(rtol=1e-4, atol=1e-6)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
PARAM_ATOL = 0.01 * 2e-4


def _batch():
    rng = np.random.RandomState(21)
    dones = np.zeros((T, B, 1), np.float32)
    dones[1, 2] = 1.0
    is_first = np.zeros((T, B, 1), np.float32)
    is_first[2, 2] = 1.0
    return {
        "rgb": rng.randint(0, 256, (T, B, 3, 64, 64)).astype(np.uint8),
        "actions": rng.uniform(-1, 1, (T, B, ACTIONS[0])).astype(np.float32),
        "rewards": rng.randn(T, B, 1).astype(np.float32),
        "dones": dones,
        "is_first": is_first,
    }


def _jax_noise(key):
    key = jax.random.fold_in(key, 0)
    k_wm, k_img = jax.random.split(key)
    posterior = jax.random.gumbel(k_wm, (T, B, S, D))
    k_gum, k_steps = jax.random.split(k_img)
    prior = jax.random.gumbel(k_gum, (HORIZON, T * B, S, D))
    actions = np.stack([
        np.asarray(jax.random.uniform(jax.random.split(k, 1)[0], (T * B, ACTIONS[0]), minval=1e-6, maxval=1 - 1e-6))
        for k in jax.random.split(k_steps, HORIZON)
    ])
    return {
        "posterior": torch.from_numpy(np.array(posterior)),
        "prior": torch.from_numpy(np.array(prior)),
        "actions": [torch.from_numpy(actions)],
    }


def _first_moments(opt_state):
    found = []

    def walk(node):
        if hasattr(node, "mu") and hasattr(node, "nu"):
            found.append(node.mu)
        elif isinstance(node, (tuple, list)):
            for n in node:
                walk(n)
        elif hasattr(node, "inner_state"):
            walk(node.inner_state)

    walk(opt_state)
    assert len(found) == 1
    return jax.device_get(found[0])


@pytest.fixture(scope="module")
def jax_side():
    fabric = Fabric(devices=1, accelerator="cpu")
    jcfg = compose(overrides=["exp=dreamer_v2", "metric.log_level=0"] + [f"{k}={v}" for k, v in SMALL.items()])
    space = gym.spaces.Dict({"rgb": gym.spaces.Box(0, 255, (3, 64, 64), np.uint8)})
    wm, actor, critic, params = jax_agent.build_agent(jcfg, ACTIONS, True, space, jax.random.PRNGKey(3))
    params["target_critic"] = jax.tree_util.tree_map(lambda p: 0.5 * p, params["target_critic"])
    txs = jax_dv2.build_optimizers_and_state(jcfg, params)
    train_fn = jax_dv2.build_train_fn(wm, actor, critic, *txs[:3], jcfg, fabric, ACTIONS, True)
    return dict(params=jax.device_get(params), state=jax.device_get(txs[3]), train_fn=train_fn)


@pytest.mark.parametrize("tau", [0.0, 1.0])
def test_continuous_train_step_matches_jax(jax_side, tau):
    key = jax.random.PRNGKey(11)
    batch = _batch()
    state0 = jax.tree_util.tree_map(jnp.array, jax_side["state"])  # the step donates its state
    new_state, j_metrics = jax.device_get(
        jax_side["train_fn"](state0, {k: jnp.asarray(v) for k, v in batch.items()}, key, jnp.float32(tau))
    )

    cfg = dreamer_v2_config("dreamer_v2", **SMALL)
    modules = build_agent(cfg, ACTIONS, True, {"rgb": (3, 64, 64)}, device="cpu", training=True)
    state_dicts, skipped = convert_dreamer_v2(jax_side["params"], training=True)
    assert skipped == [] and state_dicts["actor"]["heads.0.weight"].shape[0] == 2 * ACTIONS[0]
    names = ("world_model", "actor", "critic", "target_critic")
    for name, module in zip(names, modules):
        module.load_state_dict(state_dicts[name])
    state = build_optimizers_and_state(cfg, *modules)
    metrics = build_train_fn(cfg, ACTIONS, True)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, _jax_noise(key), tau=tau
    )

    assert set(metrics) <= set(j_metrics) and float(metrics["Grads/actor"]) > 0.0
    for name, value in metrics.items():
        np.testing.assert_allclose(float(value), float(j_metrics[name]), **METRIC_TOL, err_msg=name)
    for name in ("world_model", "actor", "critic"):
        module, opt = state[name], state["opt"][name]
        moments, _ = convert_dreamer_v2(
            {**new_state["params"], name: _first_moments(new_state["opt"][name])}, training=True
        )
        for pname, p in module.named_parameters():
            np.testing.assert_allclose(opt.state[p]["exp_avg"].numpy() / 0.1, moments[name][pname].numpy() / 0.1,
                                       **GRAD_TOL, err_msg=f"{name}.{pname} gradient")
    after, _ = convert_dreamer_v2(new_state["params"], training=True)
    for name in names:
        for pname, value in state[name].state_dict().items():
            np.testing.assert_allclose(value.numpy(), after[name][pname].numpy(), rtol=0, atol=PARAM_ATOL,
                                       err_msg=f"{name}.{pname}")

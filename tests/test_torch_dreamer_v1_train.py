"""The port's DreamerV1 training step against the JAX package on the CPU.

One whole gradient step of each side at a small width, and a two-step
burst, from the same weights (the JAX ``build_agent``'s, carried across by
``convert_dreamer_v1(..., training=True)``), the same batch (with an
episode boundary inside it: DreamerV1 does not reset there) and the same
noise: the JAX step draws its noise from its key inside the jitted program,
and this test re-derives it with JAX's own key schedule (``fold_in`` of the
data-axis index, ``split`` into the world-model and imagination keys; the
posterior's standard normals; ``split`` into the imagined priors' key and
the step keys; each step's key split once a head, Gumbels for a categorical
head, uniforms on ``[1e-6, 1 − 1e-6]`` for the continuous ``trunc_normal``
head). Seeds are never matched across the frameworks.

Two settings: discrete actions (the actor's gradient through the
straight-through samples and the imagined dynamics) at the preset's
``kl_free_nats`` (3: the state loss is clamped) without the continue head
(a constant discount γ), and continuous actions (the gradient through the
reparameterized samples) with the continue head (its probabilities × γ
discount the λ-targets) and free nats 0.

Tolerances, those of ``test_torch_dreamer_v2_train.py`` (float32 on the
CPU; XLA and PyTorch sum in different orders):

- every loss and metric: rtol 1e-4, atol 1e-6;
- gradients per module, read from the optimizers' first moments after the
  step (both are ``(1 - β1)·clipped gradient`` after one Adam step): rtol
  1e-3, atol 1e-5;
- updated parameters: atol 2e-6; where the JAX gradient lies within the
  gradient atol of zero, 2·lr (Adam's first step turns a rounding-sized
  gradient into ±lr). After the two-step burst the parameters as after one
  step and the first moments (the second step's gradient plus 0.9 of the
  first's) at rtol 1e-3 and 5e-5 of the largest element.
"""

import functools

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_jit_build import jit_build

from sheeprl_tpu.algos.dreamer_v1 import agent as jax_agent
from sheeprl_tpu.algos.dreamer_v1 import dreamer_v1 as jax_dv1
from sheeprl_tpu.config import compose
from sheeprl_tpu.fabric import Fabric
from sheeprl_tpu_torch.algos.dreamer_v1.agent import build_agent
from sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1 import build_optimizers_and_state, build_train_fn
from sheeprl_tpu_torch.configs import dreamer_v2_config
from sheeprl_tpu_torch.convert import convert_dreamer_v1
from sheeprl_tpu_torch.train.burst import run_train_burst
from test_torch_dreamer_v2_train import _first_moments

SMALL = {
    "algo.dense_units": 16,
    "algo.mlp_layers": 2,
    "algo.world_model.encoder.cnn_channels_multiplier": 2,
    "algo.world_model.recurrent_model.recurrent_state_size": 12,
    "algo.world_model.stochastic_size": 4,
    "algo.world_model.transition_model.hidden_size": 10,
    "algo.world_model.representation_model.hidden_size": 10,
    "algo.horizon": 3,
    "per_rank_batch_size": 3,
    "per_rank_sequence_length": 4,
}
T, B, HORIZON, S = 4, 3, 3, 4
MODULES = ("world_model", "actor", "critic")
#: (actions, continuous, config overrides) of each setting
SETTINGS = {
    "discrete": ((3,), False, {}),
    "continuous_continues": ((2,), True, {"algo.world_model.use_continues": True,
                                          "algo.world_model.kl_free_nats": 0.0}),
}
METRIC_TOL = dict(rtol=1e-4, atol=1e-6)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
PARAM_ATOL = 2e-6
BURST_GRAD_ATOL_OF_MAX = 5e-5


@pytest.fixture(autouse=True, scope="module")
def restore_prng_impl():
    """The JAX Fabric switches JAX's default key implementation for the
    whole process (to ``rbg``): put it back after the module, so that a
    later file on the same worker draws the keys it expects (a
    ``PRNGKey(1)`` of ``tests/test_envs/test_rollout.py`` otherwise starts
    another Pendulum trajectory)."""
    saved = jax.config.jax_default_prng_impl
    yield
    jax.config.update("jax_default_prng_impl", saved)


def _batch(actions, continuous, seed=21):
    rng = np.random.RandomState(seed)
    dones = np.zeros((T, B, 1), np.float32)
    dones[1, 2] = 1.0  # row 2's episode ends at t=1; t=2 is the next episode's first row (zero action)
    if continuous:
        acts = rng.uniform(-1, 1, (T, B, actions[0])).astype(np.float32)
    else:
        acts = np.eye(actions[0], dtype=np.float32)[rng.randint(0, actions[0], (T, B))]
    acts[2, 2] = 0.0
    return {
        "rgb": rng.randint(0, 256, (T, B, 3, 64, 64)).astype(np.uint8),
        "actions": acts,
        "rewards": rng.randn(T, B, 1).astype(np.float32),
        "dones": dones,
    }


def _jax_noise(key, actions, continuous):
    """The JAX step's noise, re-derived from its key as ``local_step``,
    ``imagination_rollout`` and ``sample_actor_actions`` split it."""
    key = jax.random.fold_in(key, 0)  # the data-axis index of the single device
    k_wm, k_img = jax.random.split(key)
    posterior = jax.random.normal(k_wm, (T, B, S))
    k_eps, k_steps = jax.random.split(k_img)
    prior = jax.random.normal(k_eps, (HORIZON, T * B, S))
    heads = [[] for _ in (actions[:1] if continuous else actions)]
    for k in jax.random.split(k_steps, HORIZON):
        for j, kh in enumerate(jax.random.split(k, len(heads))):
            if continuous:
                heads[j].append(jax.random.uniform(kh, (T * B, actions[0]), minval=1e-6, maxval=1 - 1e-6))
            else:
                heads[j].append(jax.random.gumbel(kh, (T * B, actions[j])))
    return {
        "posterior": torch.from_numpy(np.array(posterior)),
        "prior": torch.from_numpy(np.array(prior)),
        "actions": [torch.from_numpy(np.stack([np.asarray(g) for g in h])) for h in heads],
    }


@functools.lru_cache(maxsize=None)
def _jax_build(name):
    actions, continuous, extra = SETTINGS[name]
    overrides = {**SMALL, **extra}
    fabric = Fabric(devices=1, accelerator="cpu")
    jcfg = compose(overrides=["exp=dreamer_v1", "metric.log_level=0"] + [f"{k}={v}" for k, v in overrides.items()])
    space = gym.spaces.Dict({"rgb": gym.spaces.Box(0, 255, (3, 64, 64), np.uint8)})
    wm, actor, critic, params = jit_build(jax_agent.build_agent, jcfg, actions, continuous, space, jax.random.PRNGKey(3))
    txs = jax_dv1.build_optimizers_and_state(jcfg, params)
    train_fn = jax_dv1.build_train_fn(wm, actor, critic, *txs[:3], jcfg, fabric, actions, continuous)
    return dict(params=jax.device_get(params), state=jax.device_get(txs[3]), train_fn=train_fn, actions=actions,
                continuous=continuous, overrides=overrides, name=name)


@pytest.fixture(scope="module", params=sorted(SETTINGS))
def jax_side(request):
    return _jax_build(request.param)


def _torch_side(side):
    cfg = dreamer_v2_config("dreamer_v1", **side["overrides"])
    modules = build_agent(cfg, side["actions"], side["continuous"], {"rgb": (3, 64, 64)}, device="cpu",
                          training=True)
    state_dicts, skipped = convert_dreamer_v1(side["params"], training=True)
    assert skipped == []
    for name, module in zip(MODULES, modules):
        module.load_state_dict(state_dicts[name])
    return cfg, build_optimizers_and_state(cfg, *modules)


def _jax_steps(side, batches, keys):
    state = jax.tree_util.tree_map(jnp.array, side["state"])  # the step donates its state
    for batch, key in zip(batches, keys):
        state, metrics = side["train_fn"](state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    return jax.device_get(state), jax.device_get(metrics)


def _jax_grads(new_state):
    """Each module's JAX gradient (first moment over 1 − β1), in the port's layout."""
    return {name: convert_dreamer_v1({**new_state["params"], name: _first_moments(new_state["opt"][name])},
                                     training=True)[0][name] for name in MODULES}


def _check(cfg, state, new_state, metrics, j_metrics, burst=False):
    assert set(metrics) == set(j_metrics)
    for name, value in metrics.items():
        np.testing.assert_allclose(float(value), float(j_metrics[name]), **METRIC_TOL, err_msg=name)
    grads = _jax_grads(new_state)
    after, _ = convert_dreamer_v1(new_state["params"], training=True)
    for name in MODULES:
        lr = float(cfg.algo[name].optimizer.lr)
        for pname, p in state[name].named_parameters():
            want = grads[name][pname].numpy() / 0.1
            got = state["opt"][name].state[p]["exp_avg"].numpy() / 0.1
            if burst:
                atol = BURST_GRAD_ATOL_OF_MAX * max(float(np.abs(want).max()), 1.0)
                np.testing.assert_allclose(got, want, rtol=GRAD_TOL["rtol"], atol=atol, err_msg=f"{name}.{pname}")
            else:
                np.testing.assert_allclose(got, want, **GRAD_TOL, err_msg=f"{name}.{pname} gradient")
            tol = np.where(np.abs(want) <= GRAD_TOL["atol"], 2 * lr, PARAM_ATOL)
            diff = np.abs(p.detach().numpy() - after[name][pname].numpy())
            assert (diff <= tol).all(), f"{name}.{pname}: {diff.max()}"


def test_train_step_matches_jax(jax_side):
    key = jax.random.PRNGKey(11)
    actions, continuous = jax_side["actions"], jax_side["continuous"]
    batch = _batch(actions, continuous)
    new_state, j_metrics = _jax_steps(jax_side, [batch], [key])
    cfg, state = _torch_side(jax_side)
    metrics = build_train_fn(cfg, actions, continuous)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, _jax_noise(key, actions, continuous)
    )
    assert float(metrics["Grads/actor"]) > 0.0 and float(metrics["Grads/critic"]) > 0.0
    if jax_side["name"] == "discrete":  # the preset's 3 free nats clamp the state loss at this width
        assert float(metrics["Loss/state_loss"]) == 3.0 and float(metrics["State/kl"]) < 3.0
    else:
        assert float(metrics["Loss/state_loss"]) == pytest.approx(float(metrics["State/kl"]))
    assert (float(metrics["Loss/continue_loss"]) != 0.0) == (jax_side["name"] == "continuous_continues")
    _check(cfg, state, new_state, metrics, j_metrics)


def test_two_step_burst_matches_jax():
    """A burst of two gradient steps on two batches (discrete actions): the
    last step's metrics, the first moments and the parameters after both."""
    jax_side = _jax_build("discrete")
    actions, continuous = jax_side["actions"], jax_side["continuous"]
    keys = list(jax.random.split(jax.random.PRNGKey(12), 2))
    batches = [_batch(actions, continuous, 31), _batch(actions, continuous, 32)]
    new_state, j_metrics = _jax_steps(jax_side, batches, keys)
    cfg, state = _torch_side(jax_side)
    program = build_train_fn(cfg, actions, continuous)
    stack = {k: torch.from_numpy(np.stack([b[k] for b in batches])) for k in batches[0]}
    metrics = run_train_burst(program, state, stack, [0.0, 0.0],
                              noise=[_jax_noise(k, actions, continuous) for k in keys])
    assert program.static is not None and program.static.step.eager_calls == 2
    _check(cfg, state, new_state, metrics, j_metrics, burst=True)

"""The port's continuous-action DreamerV3 against the JAX package on the CPU.

At a few narrow layers with pixels (``rgb``) and a 24-wide ``state`` vector
and a 6-wide Box of actions (the DMC walker's spaces):

- ``build_actor_dists`` for ``trunc_normal``, ``normal`` and ``tanh_normal``;
- the greedy best-of-100 sample, and ``add_exploration_noise``;
- one whole train step and a two-step burst from the same weights, batch
  and noise: the JAX step draws its noise from its key inside the jitted
  program, and the test re-draws it with JAX's own key schedule (``fold_in``
  of the data-axis index, ``split`` into the world-model and imagination
  keys; the posterior Gumbels; ``split`` into the first action's key and the
  rest; ``split`` into the prior Gumbels' key and the step keys; each
  action's key split once, and its uniforms on ``[1e-6, 1 − 1e-6]`` drawn
  from it). The actor learns by dynamics backprop, so its gradient flows
  back through the imagination; the critic's and the world model's
  gradients must equal JAX's, which differentiates the actor loss in the
  actor alone (a leak of the actor's loss into either would show there).

``test_torch_dreamer_v3_continuous_cli.py`` serves a JAX continuous
checkpoint.

Tolerances (float32 on the CPU; XLA and PyTorch sum in different orders):
losses and metrics rtol 1e-4, atol 1e-6; gradients per module (read from
the optimizers' first moments) rtol 1e-3, atol 2e-5 of each gradient's
largest magnitude; parameters after one step atol 1.6e-6, after the burst
4e-6 (as ``test_torch_dreamer_v3_train.py`` states them). After the burst the
first moments hold the second step's gradients, taken at parameters that the
first Adam step already left up to 1.6e-6 apart: the pixel encoder's
LayerNorm gradients then read up to 3.4e-5 of their largest element apart,
so the burst's gradient atol is 5e-5 of it (one step reads at most 7.1e-6). Distribution
values rtol 1e-5, atol 1e-6; samples through the inverse cdf rtol 1e-4,
atol 1e-5. The best of 100 samples is the first of the largest
``log_prob`` (``argmax``'s rule on both sides): where JAX's two best
``log_prob`` differ by less than 1e-4 the test holds only the chosen
``log_prob`` to the best one, else the chosen action itself.
"""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v3 import agent as jax_agent
from sheeprl_tpu.algos.dreamer_v3 import dreamer_v3 as jax_dv3
from sheeprl_tpu.config import compose
from sheeprl_tpu.fabric import Fabric
from sheeprl_tpu_torch.algos.dreamer_v3.agent import (
    GREEDY_SAMPLES,
    actor_entropy,
    add_exploration_noise,
    build_actor_dists,
    build_agent,
    sample_actor_actions,
)
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import build_optimizers_and_state, build_train_fn
from sheeprl_tpu_torch.configs import dreamer_v3_config
from sheeprl_tpu_torch.convert import convert_dreamer_v3
from sheeprl_tpu_torch.train.burst import run_train_burst

EXP = "dreamer_v3_dmc_walker_walk"
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
    "per_rank_batch_size": 3,
    "per_rank_sequence_length": 4,
}
T, B, HORIZON, S, D = 4, 3, 3, 4, 4
ACTIONS = (6,)
STATE = 24
METRIC_TOL = dict(rtol=1e-4, atol=1e-6)
GRAD_RTOL, GRAD_ATOL_OF_MAX, BURST_GRAD_ATOL_OF_MAX = 1e-3, 2e-5, 5e-5
PARAM_ATOL = 0.02 * 8e-5
BURST_PARAM_ATOL = 0.05 * 8e-5
VAL_TOL = dict(rtol=1e-5, atol=1e-6)
SAMPLE_TOL = dict(rtol=1e-4, atol=1e-5)
TIE = 1e-4
MODULES = ("world_model", "actor", "critic", "target_critic")
SPACE = {"rgb": (3, 64, 64), "state": (STATE,)}


def _batch(seed=21):
    rng = np.random.RandomState(seed)
    dones = np.zeros((T, B, 1), np.float32)
    dones[1, 2] = 1.0
    is_first = np.zeros((T, B, 1), np.float32)
    is_first[2, 2] = 1.0
    return {
        "rgb": rng.randint(0, 256, (T, B, 3, 64, 64)).astype(np.uint8),
        "state": (2.0 * rng.randn(T, B, STATE)).astype(np.float32),
        "actions": rng.uniform(-1, 1, (T, B, ACTIONS[0])).astype(np.float32),
        "rewards": rng.rand(T, B, 1).astype(np.float32),
        "dones": dones,
        "is_first": is_first,
    }


def _uniforms(key, shape):
    return np.array(jax.random.uniform(key, shape, minval=1e-6, maxval=1 - 1e-6))


def _jax_noise(key):
    """The JAX step's noise, re-derived from its key as ``local_step``,
    ``imagination_rollout`` and ``sample_actor_actions`` split it."""
    key = jax.random.fold_in(key, 0)
    k_wm, k_img = jax.random.split(key)
    posterior = jax.random.gumbel(k_wm, (T, B, S, D))
    k0, key = jax.random.split(k_img)
    k_gum, key = jax.random.split(key)
    prior = jax.random.gumbel(k_gum, (HORIZON, T * B, S, D))
    steps = [k0] + list(jax.random.split(key, HORIZON))
    actions = np.stack([_uniforms(jax.random.split(k, 1)[0], (T * B, ACTIONS[0])) for k in steps])
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
    jcfg = compose(overrides=[f"exp={EXP}", "metric.log_level=0"] + [f"{k}={v}" for k, v in SMALL.items()])
    space = gym.spaces.Dict({
        "rgb": gym.spaces.Box(0, 255, (3, 64, 64), np.uint8),
        "state": gym.spaces.Box(-np.inf, np.inf, (STATE,), np.float32),
    })
    wm, actor, critic, params = jax_agent.build_agent(jcfg, ACTIONS, True, space, jax.random.PRNGKey(3))
    # the reward and critic heads start at zero (Hafner): move them, and the target critic off the critic, so
    # that the returns, the advantage (the continuous actor's whole objective) and the target term are live
    rng = np.random.RandomState(8)
    for tree in (params["world_model"]["reward_model"], params["critic"]):
        tree["head"]["kernel"] = jnp.asarray(0.3 * rng.randn(*tree["head"]["kernel"].shape).astype(np.float32))
    params["target_critic"] = jax.tree_util.tree_map(lambda p: 0.5 * p, params["critic"])
    txs = jax_dv3.build_optimizers_and_state(jcfg, params)
    train_fn = jax_dv3.build_train_fn(wm, actor, critic, *txs[:3], jcfg, fabric, ACTIONS, True)
    return dict(params=jax.device_get(params), state=jax.device_get(txs[3]), train_fn=train_fn)


def _torch_side(params):
    cfg = dreamer_v3_config(EXP, **SMALL)
    modules = build_agent(cfg, ACTIONS, True, SPACE, device="cpu", training=True)
    state_dicts, skipped = convert_dreamer_v3(params, training=True)
    assert skipped == []
    assert state_dicts["actor"]["heads.0.weight"].shape[0] == 2 * ACTIONS[0]
    for name, module in zip(MODULES, modules):
        module.load_state_dict(state_dicts[name])
    return cfg, build_optimizers_and_state(cfg, *modules)


def _jax_steps(jax_side, batches, keys, taus):
    state = jax.tree_util.tree_map(jnp.array, jax_side["state"])
    for batch, key, tau in zip(batches, keys, taus):
        state, metrics = jax_side["train_fn"](state, {k: jnp.asarray(v) for k, v in batch.items()}, key,
                                              jnp.float32(tau))
    return jax.device_get(state), jax.device_get(metrics)


def _check(state, new_state, metrics, j_metrics, param_atol, grad_atol_of_max=GRAD_ATOL_OF_MAX):
    assert set(metrics) == set(j_metrics)
    for name, value in metrics.items():
        np.testing.assert_allclose(float(value), float(j_metrics[name]), **METRIC_TOL, err_msg=name)
    for name in ("world_model", "actor", "critic"):
        module, opt = state[name], state["opt"][name]
        moments, _ = convert_dreamer_v3(
            {**new_state["params"], name: _first_moments(new_state["opt"][name])}, training=True
        )
        for pname, p in module.named_parameters():
            want = moments[name][pname].numpy() / 0.1
            np.testing.assert_allclose(
                opt.state[p]["exp_avg"].numpy() / 0.1, want, rtol=GRAD_RTOL,
                atol=grad_atol_of_max * max(float(np.abs(want).max()), 1.0), err_msg=f"{name}.{pname} gradient",
            )
    after, _ = convert_dreamer_v3(new_state["params"], training=True)
    for name in MODULES:
        for pname, value in state[name].state_dict().items():
            np.testing.assert_allclose(value.numpy(), after[name][pname].numpy(), rtol=0, atol=param_atol,
                                       err_msg=f"{name}.{pname}")
    for k in ("low", "high"):
        np.testing.assert_allclose(float(state["moments"][k]), float(new_state["moments"][k]), **METRIC_TOL)


def test_train_step_matches_jax(jax_side):
    """One step: the losses, every module's gradient (the critic's and the
    world model's unpolluted by the actor's loss) and the parameters."""
    key = jax.random.PRNGKey(11)
    batch = _batch()
    new_state, j_metrics = _jax_steps(jax_side, [batch], [key], [0.02])
    cfg, state = _torch_side(jax_side["params"])
    metrics = build_train_fn(cfg, ACTIONS, True)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, _jax_noise(key), tau=0.02
    )
    assert float(metrics["Grads/actor"]) > 0.0
    _check(state, new_state, metrics, j_metrics, PARAM_ATOL)


def test_two_step_burst_matches_jax(jax_side):
    keys = list(jax.random.split(jax.random.PRNGKey(12), 2))
    batches = [_batch(31), _batch(32)]
    taus = [1.0, 0.02]
    new_state, j_metrics = _jax_steps(jax_side, batches, keys, taus)
    cfg, state = _torch_side(jax_side["params"])
    program = build_train_fn(cfg, ACTIONS, True)
    stack = {k: torch.from_numpy(np.stack([b[k] for b in batches])) for k in batches[0]}
    metrics = run_train_burst(program, state, stack, taus, noise=[_jax_noise(k) for k in keys])
    assert program.static is not None and program.static.step.eager_calls == 2
    _check(state, new_state, metrics, j_metrics, BURST_PARAM_ATOL, BURST_GRAD_ATOL_OF_MAX)


def _pre_dist(seed, rows=9):
    return (1.5 * np.random.RandomState(seed).randn(rows, 2 * ACTIONS[0])).astype(np.float32)


@pytest.mark.parametrize("distribution", ["trunc_normal", "normal", "tanh_normal"])
def test_build_actor_dists_match_jax(distribution):
    pre = _pre_dist(1)
    args = (True, distribution, 0.3, 0.1)
    (mine,), (theirs,) = build_actor_dists([torch.from_numpy(pre)], *args), jax_agent.build_actor_dists(
        [jnp.asarray(pre)], *args
    )
    np.testing.assert_allclose(mine.mean.numpy(), np.asarray(theirs.mean), **VAL_TOL)
    np.testing.assert_allclose(mine.mode.numpy(), np.asarray(theirs.mode), **VAL_TOL)
    value = np.clip(np.random.RandomState(2).randn(9, ACTIONS[0]), -0.99, 0.99).astype(np.float32)
    np.testing.assert_allclose(mine.log_prob(torch.from_numpy(value)).numpy(),
                               np.asarray(theirs.log_prob(jnp.asarray(value))), **VAL_TOL)
    np.testing.assert_allclose(actor_entropy([mine], distribution).numpy(),
                               np.asarray(jax_agent.actor_entropy([theirs], distribution)), **VAL_TOL)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jax_agent.sample_actor_actions([theirs], True, key, True)[0])
    k = jax.random.split(key, 1)[0]
    noise = _uniforms(k, want.shape) if distribution == "trunc_normal" else np.array(jax.random.normal(k, want.shape))
    got = sample_actor_actions([mine], True, noise=[torch.from_numpy(noise)])[0]
    np.testing.assert_allclose(got.numpy(), want, **SAMPLE_TOL)


def test_greedy_best_of_100_matches_jax():
    pre = _pre_dist(5, rows=32)
    (mine,), (theirs,) = (f([g(pre)], True, "trunc_normal") for f, g in (
        (build_actor_dists, torch.from_numpy), (jax_agent.build_actor_dists, jnp.asarray)))
    key = jax.random.PRNGKey(6)
    want = np.asarray(jax_agent.sample_actor_actions([theirs], True, key, False)[0])
    noise = _uniforms(jax.random.split(key, 1)[0], (GREEDY_SAMPLES, 32, ACTIONS[0]))
    got = sample_actor_actions([mine], True, is_training=False, noise=[torch.from_numpy(noise)])[0].numpy()
    assert got.shape == want.shape == (32, ACTIONS[0])
    j_lp = np.asarray(theirs.log_prob(jnp.asarray(np.clip(theirs.base.icdf(jnp.asarray(noise)), -1, 1))))
    best = j_lp.max(0)
    second = np.sort(j_lp, 0)[-2]
    np.testing.assert_allclose(mine.log_prob(torch.from_numpy(got)).numpy(), best, **SAMPLE_TOL)
    clear = best - second > TIE
    assert clear.sum() >= 24  # most rows have no near-tie at this seed
    np.testing.assert_allclose(got[clear], want[clear], **SAMPLE_TOL)


@pytest.mark.parametrize("expl_amount", [0.0, 0.3])
def test_add_exploration_noise_matches_jax(expl_amount):
    actions = np.random.RandomState(7).uniform(-1, 1, (5, ACTIONS[0])).astype(np.float32)
    key = jax.random.PRNGKey(8)
    want = jax_agent.add_exploration_noise([jnp.asarray(actions)], jnp.float32(expl_amount), True, key)[0]
    eps = np.array(jax.random.normal(key, actions.shape))
    got = add_exploration_noise([torch.from_numpy(actions)], torch.tensor(expl_amount), True,
                                [torch.from_numpy(eps)])[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VAL_TOL)
    assert float(got.abs().max()) <= 1.0
    if expl_amount == 0.0:
        assert np.array_equal(got.numpy(), actions)

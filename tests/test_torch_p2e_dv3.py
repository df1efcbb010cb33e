"""The port's Plan2Explore on DreamerV3 against the JAX package on the CPU.

The JAX ``build_agent``'s weights at a small width (the reward head, the
task critic's and every exploration critic's heads moved off their Hafner
zeros, each target at half its critic, so that every term of the six losses
is live) carried across by ``convert_p2e_dv3(..., training=True)``; the same
batch; the noise the JAX step draws from its key re-derived with its key
schedule (``fold_in`` of the data-axis index, ``split`` into the world-model,
exploration and task keys, each imagination's first-action, prior and step
keys, one key a head) and handed to the port as tensors.

Tolerances, those of ``test_torch_dreamer_v3_train.py`` (float32 on the
CPU, another summation order): every loss and metric rtol 1e-4, atol 1e-6;
each optimizer's first moment (the clipped gradient times 1 − β1) rtol 1e-3,
atol 2e-5 of the gradient's largest magnitude; parameters and targets after
the step atol 1.6e-6, and ``2·lr`` more where the JAX gradient lies within
that gradient tolerance of zero (its sign there is float32 rounding, and
Adam's first step moves such an element by up to ``lr`` either way: one
element of the decoder's projection at this seed read 1.96e-4); every ``Moments`` state rtol 1e-4, atol 1e-6; the
ensemble's forward, the intrinsic reward and the ensemble loss rtol 1e-5,
atol 1e-6.

Discrete actions here (the 100k MsPacman preset's pixels and 9 actions);
``test_torch_p2e_dv3_continuous.py`` holds the same checks on continuous
actions, ``test_torch_p2e_dv3_cli.py`` the CLI.
"""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_jit_build import jit_build

from sheeprl_tpu.algos.p2e_dv3 import agent as jax_agent
from sheeprl_tpu.algos.p2e_dv3 import p2e_dv3_exploration as jax_expl
from sheeprl_tpu.config import compose
from sheeprl_tpu.config.instantiate import instantiate as jax_instantiate
from sheeprl_tpu.distributions import MSEDistribution as JaxMSE
from sheeprl_tpu.fabric import Fabric
from sheeprl_tpu_torch.algos.p2e_dv3.agent import build_agent
from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_exploration import (
    build_losses,
    build_optimizers_and_state,
    build_train_fn,
    intrinsic_reward,
)
from sheeprl_tpu_torch.convert import convert_p2e_dv3

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
    "algo.ensembles.n": 4,
    "per_rank_batch_size": 3,
    "per_rank_sequence_length": 4,
}
T, B, HORIZON, S, D = 4, 3, 3, 4, 4
STATE = 24
METRIC_TOL = dict(rtol=1e-4, atol=1e-6)
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-3, 2e-5
PARAM_ATOL = 0.02 * 8e-5
FN_TOL = dict(rtol=1e-5, atol=1e-6)
CRITICS = ("intrinsic", "extrinsic")
# (actions, continuous, observation shapes): the 100k MsPacman pixels and 9 actions; the walker's pixels and state
# with 6 continuous actions through a trunc_normal actor that learns by dynamics backprop
CASES = {
    "discrete": ((9,), False, {"rgb": (3, 64, 64)}),
    "continuous": ((6,), True, {"rgb": (3, 64, 64), "state": (STATE,)}),
}
CONTINUOUS_KEYS = ["cnn_keys.encoder=[rgb]", "cnn_keys.decoder=[rgb]", "mlp_keys.encoder=[state]",
                   "mlp_keys.decoder=[state]", "distribution.type=trunc_normal"]


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


def _overrides(case):
    return [f"{k}={v}" for k, v in SMALL.items()] + (CONTINUOUS_KEYS if CASES[case][1] else [])


def _torch_cfg(case):
    from sheeprl_tpu_torch.config import compose as port_compose

    return port_compose(overrides=["exp=p2e_dv3_exploration", "metric.log_level=0"] + _overrides(case))


def _batch(case, seed=21):
    actions, continuous, obs = CASES[case]
    rng = np.random.RandomState(seed)
    dones = np.zeros((T, B, 1), np.float32)
    dones[1, 2] = 1.0
    is_first = np.zeros((T, B, 1), np.float32)
    is_first[2, 2] = 1.0  # row 2 starts a new episode after its done
    batch = {"rgb": rng.randint(0, 256, (T, B, 3, 64, 64)).astype(np.uint8)}
    if "state" in obs:
        batch["state"] = (2.0 * rng.randn(T, B, STATE)).astype(np.float32)
    if continuous:
        batch["actions"] = rng.uniform(-1, 1, (T, B, actions[0])).astype(np.float32)
    else:
        batch["actions"] = np.eye(actions[0], dtype=np.float32)[rng.randint(0, actions[0], (T, B))]
    batch.update(rewards=(3.0 * rng.randn(T, B, 1)).astype(np.float32), dones=dones, is_first=is_first)
    return batch


def _imagination_noise(key, case):
    """One JAX imagination's noise from its key: the first action's key, the
    prior Gumbels' key and a key a step, split per head (the continuous
    head's uniforms on [1e-6, 1 − 1e-6])."""
    actions, continuous, _ = CASES[case]
    k0, key = jax.random.split(key)
    k_gum, key = jax.random.split(key)
    prior = jax.random.gumbel(k_gum, (HORIZON, T * B, S, D))
    steps = [k0] + list(jax.random.split(key, HORIZON))
    if continuous:
        heads = [[np.array(jax.random.uniform(jax.random.split(k, 1)[0], (T * B, actions[0]), minval=1e-6,
                                              maxval=1 - 1e-6)) for k in steps]]
    else:
        heads = [[np.asarray(jax.random.gumbel(jax.random.split(k, len(actions))[j], (T * B, a))) for k in steps]
                 for j, a in enumerate(actions)]
    return torch.from_numpy(np.array(prior)), [torch.from_numpy(np.stack(h)) for h in heads]


def _jax_noise(key, case):
    """The JAX step's noise: ``fold_in(key, 0)``, ``split`` into the world
    model's, the exploration actor's and the task actor's keys."""
    key = jax.random.fold_in(key, 0)  # the data-axis index of the single device
    k_wm, k_expl, k_task = jax.random.split(key, 3)
    expl_prior, expl_actions = _imagination_noise(k_expl, case)
    prior, actions = _imagination_noise(k_task, case)
    return {
        "posterior": torch.from_numpy(np.array(jax.random.gumbel(k_wm, (T, B, S, D)))),
        "prior": prior, "actions": actions, "exploration_prior": expl_prior, "exploration_actions": expl_actions,
    }


def _first_moments(opt_state):
    """The ``mu`` tree of an optax chain(clip, inject_hyperparams(adam)) state."""
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


def _jax_build(case):
    actions, continuous, obs = CASES[case]
    jcfg = compose(overrides=["exp=p2e_dv3_exploration", "env=dummy", "metric.log_level=0"] + _overrides(case))
    space = gym.spaces.Dict({
        k: gym.spaces.Box(0, 255, shape, np.uint8) if len(shape) == 3 else gym.spaces.Box(-np.inf, np.inf, shape)
        for k, shape in obs.items()
    })
    wm, actor, critic, member, params = jit_build(jax_agent.build_agent, jcfg, actions, continuous, space, jax.random.PRNGKey(3))
    rng = np.random.RandomState(8)
    heads = [params["world_model"]["reward_model"], params["critic_task"]]
    heads += [params["critics_exploration"][k]["module"] for k in CRITICS]
    for tree in heads:
        tree["head"]["kernel"] = jnp.asarray(0.3 * rng.randn(*tree["head"]["kernel"].shape).astype(np.float32))
    half = lambda t: jax.tree_util.tree_map(lambda p: 0.5 * p, t)  # noqa: E731
    params["target_critic_task"] = half(params["critic_task"])
    for k in CRITICS:
        params["critics_exploration"][k]["target"] = half(params["critics_exploration"][k]["module"])
    return jcfg, (wm, actor, critic, member), params


def make_jax_side(case):
    """The JAX side of a case: its params, its step's state (``Moments``
    off zero, so that their decay is live) and its jitted step."""
    actions, continuous, _ = CASES[case]
    jcfg, (wm, actor, critic, member), params = _jax_build(case)
    a = jcfg.algo
    txs = {
        "world_model": jax_instantiate(a.world_model.optimizer, max_grad_norm=a.world_model.clip_gradients),
        "ensembles": jax_instantiate(a.ensembles.optimizer, max_grad_norm=a.ensembles.clip_gradients),
        "actor_task": jax_instantiate(a.actor.optimizer, max_grad_norm=a.actor.clip_gradients),
        "critic_task": jax_instantiate(a.critic.optimizer, max_grad_norm=a.critic.clip_gradients),
        "actor_exploration": jax_instantiate(a.actor.optimizer, max_grad_norm=a.actor.clip_gradients),
        "critics_exploration": jax_instantiate(a.critic.optimizer, max_grad_norm=a.critic.clip_gradients),
    }
    opt = {name: txs[name].init(params[name]) for name in txs if name != "critics_exploration"}
    opt["critics_exploration"] = {k: txs["critics_exploration"].init(params["critics_exploration"][k]["module"])
                                  for k in CRITICS}
    rng = np.random.RandomState(9)  # Moments states off zero, so that their decay is live
    moments = lambda: {"low": jnp.float32(-rng.rand()), "high": jnp.float32(1.0 + rng.rand())}  # noqa: E731
    state = {"params": params, "opt": opt, "moments": {"task": moments(), "exploration": {k: moments() for k in CRITICS}}}
    train_fn = jax_expl.build_train_fn(wm, actor, critic, member, txs, jcfg, Fabric(devices=1, accelerator="cpu"),
                                       actions, continuous)
    return dict(case=case, params=jax.device_get(params), state=jax.device_get(state), train_fn=train_fn,
                member=member)


@pytest.fixture(scope="module")
def jax_side():
    return make_jax_side("discrete")


def _torch_side(jax_side):
    case = jax_side["case"]
    actions, continuous, obs = CASES[case]
    cfg = _torch_cfg(case)
    modules = build_agent(cfg, actions, continuous, obs, device="cpu")
    state_dicts, skipped = convert_p2e_dv3(jax_side["params"], training=True)
    assert skipped == []
    names = ("world_model", "actor_task", "critic_task", "target_critic_task", "actor_exploration")
    for name, module in zip(names, modules):
        module.load_state_dict(state_dicts[name])
    for k, pair in modules[5].items():
        for part in ("module", "target"):
            pair[part].load_state_dict(state_dicts["critics_exploration"][k][part])
    modules[6].load_state_dict(state_dicts["ensembles"])
    state = build_optimizers_and_state(cfg, *modules)
    moments = jax_side["state"]["moments"]
    for k, v in state["moments"]["task"].items():
        v.fill_(float(moments["task"][k]))
    for name, m in state["moments"]["exploration"].items():
        for k, v in m.items():
            v.fill_(float(moments["exploration"][name][k]))
    return cfg, state


def _jax_step(jax_side, batch, key, tau):
    state = jax.tree_util.tree_map(jnp.array, jax_side["state"])  # the step donates its state
    state, metrics = jax_side["train_fn"](state, {k: jnp.asarray(v) for k, v in batch.items()}, key, jnp.float32(tau))
    return jax.device_get(state), jax.device_get(metrics)


def _assert_module(module, sd, what, grads=None, lr=0.0):
    """Parameters after the step within PARAM_ATOL; where the step's JAX
    gradient is within the gradient tolerance of zero its sign is float32
    rounding, and Adam's first step moves it by up to ``lr`` either way, so
    there the two sides may differ by ``2·lr`` more."""
    for pname, value in module.state_dict().items():
        want = sd[pname].numpy()
        atol = np.full(want.shape, PARAM_ATOL, np.float32)
        if grads is not None and pname in grads:
            g = np.abs(grads[pname])
            atol[g <= GRAD_ATOL_OF_MAX * max(float(g.max()), 1.0)] += 2 * lr
        err = np.abs(value.numpy() - want)
        assert (err <= atol).all(), f"{what}.{pname}: max error {err.max()} at {np.unravel_index(err.argmax(), err.shape)}"


def _assert_grads(module, opt, mu_sd, what):
    grads = {}
    for pname, p in module.named_parameters():
        want = grads[pname] = mu_sd[pname].numpy() / 0.1
        np.testing.assert_allclose(
            opt.state[p]["exp_avg"].numpy() / 0.1, want, rtol=GRAD_RTOL,
            atol=GRAD_ATOL_OF_MAX * max(float(np.abs(want).max()), 1.0), err_msg=f"{what}.{pname} gradient",
        )
    return grads


def check_exploration_step(jax_side, tau):
    """One whole exploration step: the six updates' losses, metrics and
    gradients, the parameters and targets after it, and every ``Moments``."""
    case = jax_side["case"]
    actions, continuous, _ = CASES[case]
    key = jax.random.PRNGKey(11)
    batch = _batch(case)
    new_state, j_metrics = _jax_step(jax_side, batch, key, tau)

    cfg, state = _torch_side(jax_side)
    metrics = build_train_fn(cfg, actions, continuous)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, _jax_noise(key, case), tau=tau
    )
    assert set(metrics) == set(j_metrics)
    for name, value in metrics.items():
        np.testing.assert_allclose(float(value), float(j_metrics[name]), **METRIC_TOL, err_msg=name)

    params, opt = new_state["params"], new_state["opt"]
    after, _ = convert_p2e_dv3(params, training=True)
    a = cfg.algo
    lrs = {"world_model": a.world_model.optimizer.lr, "ensembles": a.ensembles.optimizer.lr,
           "actor_exploration": a.actor.optimizer.lr, "actor_task": a.actor.optimizer.lr,
           "critic_task": a.critic.optimizer.lr}
    for name, lr in lrs.items():
        mu, _ = convert_p2e_dv3({**params, name: _first_moments(opt[name])}, training=True)
        grads = _assert_grads(state[name], state["opt"][name], mu[name], name)
        _assert_module(state[name], after[name], name, grads, float(lr))
    _assert_module(state["target_critic_task"], after["target_critic_task"], "target_critic_task")
    for k in CRITICS:
        tree = {**params, "critics_exploration": {**params["critics_exploration"]}}
        tree["critics_exploration"][k] = {"module": _first_moments(opt["critics_exploration"][k]),
                                          "target": params["critics_exploration"][k]["target"]}
        mu, _ = convert_p2e_dv3(tree, training=True)
        pair, want = state["critics_exploration"][k], after["critics_exploration"][k]
        grads = _assert_grads(pair["module"], state["opt"]["critics_exploration"][k],
                              mu["critics_exploration"][k]["module"], f"critics_exploration.{k}")
        _assert_module(pair["module"], want["module"], f"critics_exploration.{k}", grads, float(a.critic.optimizer.lr))
        _assert_module(pair["target"], want["target"], f"critics_exploration.{k}.target")
    want_moments = new_state["moments"]
    for k in ("low", "high"):
        np.testing.assert_allclose(float(state["moments"]["task"][k]), float(want_moments["task"][k]), **METRIC_TOL)
        for name in CRITICS:
            np.testing.assert_allclose(float(state["moments"]["exploration"][name][k]),
                                       float(want_moments["exploration"][name][k]), **METRIC_TOL, err_msg=name)


def check_ensemble(jax_side):
    """The stacked ensemble's forward on a shared input, the intrinsic reward
    (population variance over members, ddof 0) and the ensemble loss (an MSE
    against the next posterior, the last step dropped)."""
    case = jax_side["case"]
    actions, continuous, _ = CASES[case]
    cfg, state = _torch_side(jax_side)
    ens = state["ensembles"]
    rng = np.random.RandomState(4)
    width = ens.input_dim
    x = rng.randn(HORIZON + 1, 5, width).astype(np.float32)
    want = np.asarray(jax_agent.apply_ensemble(jax_side["member"], jax_side["params"]["ensembles"], jnp.asarray(x)))
    with torch.no_grad():
        got = ens(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (ens.n, HORIZON + 1, 5, S * D)
    np.testing.assert_allclose(got, want, **FN_TOL)

    mult = 2.5
    want_r = np.asarray(jnp.var(jnp.asarray(want), axis=0).mean(-1, keepdims=True) * mult)
    got_r = intrinsic_reward(ens, torch.from_numpy(x[..., : S * D + 32]), torch.from_numpy(x[..., S * D + 32:]), mult)
    np.testing.assert_allclose(got_r.numpy(), want_r, **FN_TOL)
    assert not np.allclose(got_r.numpy(), want_r * 4 / 3, rtol=1e-3)  # ddof 1 would read 4/3 of it at 4 members

    post = rng.randn(T, B, S * D).astype(np.float32)
    rec = rng.randn(T, B, 32).astype(np.float32)
    act = rng.randn(T, B, sum(actions)).astype(np.float32)
    out = jax_agent.apply_ensemble(jax_side["member"], jax_side["params"]["ensembles"],
                                   jnp.concatenate([post, rec, act], -1))[:, :-1]
    want_loss = -jnp.sum(jnp.mean(JaxMSE(out, dims=1).log_prob(jnp.asarray(post[1:])[None]), axis=(1, 2)))
    loss = build_losses(cfg, actions, continuous).ensemble_loss(
        ens, torch.from_numpy(post), torch.from_numpy(rec), torch.from_numpy(act)
    )
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), **FN_TOL)


@pytest.mark.parametrize("tau", [0.02, 1.0])
def test_exploration_step_matches_jax(jax_side, tau):
    check_exploration_step(jax_side, tau)


def test_ensemble_intrinsic_reward_and_loss_match_jax(jax_side):
    check_ensemble(jax_side)


def test_converter_serving_keeps_the_task_actor_and_raises_on_unknown(jax_side):
    params = jax_side["params"]
    served, skipped = convert_p2e_dv3(params)
    assert set(served) == {"world_model", "actor_task"}
    assert any(p.startswith("ensembles/") for p in skipped)
    assert any(p.startswith("critics_exploration/intrinsic/module/") for p in skipped)
    assert any(p.startswith("world_model/reward_model/") for p in skipped)
    with pytest.raises(KeyError, match="unknown param tree"):
        convert_p2e_dv3({**params, "critic_exploration": params["critic_task"]}, training=True)
    bad = {**params, "ensembles": {**params["ensembles"], "extra": {"kernel": np.zeros((2, 2))}}}
    with pytest.raises(KeyError, match="unknown ensembles"):
        convert_p2e_dv3(bad, training=True)
    missing = {k: v for k, v in params.items() if k != "ensembles"}
    with pytest.raises(KeyError, match="missing"):
        convert_p2e_dv3(missing, training=True)

"""The port's Plan2Explore exploration step on DreamerV3 under
``fabric.precision=bf16-mixed`` against the JAX package's on the CPU.

The JAX meaning: the world model, both actors and every critic compute in
bf16 with f32 parameters; the ensemble takes no ``dtype`` and stays f32
(``sheeprl_tpu/algos/p2e_dv3/agent.py:43-62``). The harness is
``test_torch_p2e_dv3.py``'s (the JAX ``build_agent``'s weights at a small
width with every head moved off zero, the JAX step's own noise re-derived
from its key) on vector observations (``state``, the MLP encoder and
decoder) and 9 discrete actions: the pixel decoder's bias gradient is the
JAX step's bf16 sum of 12,288 pixels a row, which ``test_torch_bf16.py``
sets out.

Tolerances, ``test_torch_bf16.py``'s, from bf16's 2^-8 (one rounding to
nearest moves a value by up to 2^-8 of it; the port's cell keeps z, the
LayerNorm and the gates in f32 where
JAX's reference cell rounds them): every loss and metric rtol 16·2^-8, atol
16·2^-8 · 0.1; each optimizer's first moment within 32·2^-8 of its norm
(``‖got − want‖ ≤ 32·2^-8 ‖want‖``) and each element within 32·2^-8 of the
gradient's largest magnitude (twice ``test_torch_bf16.py``'s element bound:
six updates here, two imaginations that each sample 48 actions and 144
latent categoricals, and a categorical sample whose two best scores lie within a few 2^-8 of each
other can go either way, moving one imagined row's share of a critic's
gradient: the task critic's second layer read 3.2% of its norm apart, the
extrinsic exploration critic's 6.6%, one element of it 7.4% of its
largest); parameters after the step atol 2% of the learning rate, and
``2·lr`` more where the gradient lies within that tolerance of zero
(Adam's first step is ``±lr`` there); every ``Moments`` state rtol 16·2^-8.
The ensemble's own arithmetic is f32: on the same f32 input its forward
matches the JAX ensemble's at the f32 suite's rtol 1e-5, atol 1e-6.
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
from sheeprl_tpu.fabric import Fabric
from sheeprl_tpu_torch.algos.p2e_dv3.agent import build_agent
from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_exploration import build_optimizers_and_state, build_train_fn
from sheeprl_tpu_torch.config import compose as port_compose
from sheeprl_tpu_torch.convert import convert_p2e_dv3
from test_torch_p2e_dv3 import CRITICS, SMALL, _first_moments

BF16 = 2.0**-8
METRIC_TOL = dict(rtol=16 * BF16, atol=16 * BF16 * 0.1)
GRAD_ATOL_OF_MAX = 32 * BF16
GRAD_NORM_RTOL = 32 * BF16
T, B, HORIZON, S, D = 4, 3, 3, 4, 4
STATE = 24
ACTIONS = (9,)
OVERRIDES = [f"{k}={v}" for k, v in SMALL.items()] + [
    "fabric.precision=bf16-mixed", "cnn_keys.encoder=[]", "cnn_keys.decoder=[]", "mlp_keys.encoder=[state]",
    "mlp_keys.decoder=[state]",
]


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


def _batch(seed=21):
    rng = np.random.RandomState(seed)
    dones = np.zeros((T, B, 1), np.float32)
    dones[1, 2] = 1.0
    is_first = np.zeros((T, B, 1), np.float32)
    is_first[2, 2] = 1.0
    return {
        "state": (2.0 * rng.randn(T, B, STATE)).astype(np.float32),
        "actions": np.eye(ACTIONS[0], dtype=np.float32)[rng.randint(0, ACTIONS[0], (T, B))],
        "rewards": (3.0 * rng.randn(T, B, 1)).astype(np.float32),
        "dones": dones,
        "is_first": is_first,
    }


def _imagination_noise(key):
    k0, key = jax.random.split(key)
    k_gum, key = jax.random.split(key)
    prior = jax.random.gumbel(k_gum, (HORIZON, T * B, S, D))
    steps = [k0] + list(jax.random.split(key, HORIZON))
    heads = [np.asarray(jax.random.gumbel(jax.random.split(k, 1)[0], (T * B, ACTIONS[0]))) for k in steps]
    return torch.from_numpy(np.array(prior)), [torch.from_numpy(np.stack(heads))]


def _jax_noise(key):
    key = jax.random.fold_in(key, 0)
    k_wm, k_expl, k_task = jax.random.split(key, 3)
    expl_prior, expl_actions = _imagination_noise(k_expl)
    prior, actions = _imagination_noise(k_task)
    return {
        "posterior": torch.from_numpy(np.array(jax.random.gumbel(k_wm, (T, B, S, D)))),
        "prior": prior, "actions": actions, "exploration_prior": expl_prior, "exploration_actions": expl_actions,
    }


def _jax_side():
    jcfg = compose(overrides=["exp=p2e_dv3_exploration", "env=dummy", "metric.log_level=0"] + OVERRIDES)
    space = gym.spaces.Dict({"state": gym.spaces.Box(-np.inf, np.inf, (STATE,))})
    wm, actor, critic, member, params = jit_build(jax_agent.build_agent, jcfg, ACTIONS, False, space, jax.random.PRNGKey(3))
    rng = np.random.RandomState(8)
    heads = [params["world_model"]["reward_model"], params["critic_task"]]
    heads += [params["critics_exploration"][k]["module"] for k in CRITICS]
    for tree in heads:
        tree["head"]["kernel"] = jnp.asarray(0.3 * rng.randn(*tree["head"]["kernel"].shape).astype(np.float32))
    half = lambda t: jax.tree_util.tree_map(lambda p: 0.5 * p, t)  # noqa: E731
    params["target_critic_task"] = half(params["critic_task"])
    for k in CRITICS:
        params["critics_exploration"][k]["target"] = half(params["critics_exploration"][k]["module"])
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
    rng = np.random.RandomState(9)
    moments = lambda: {"low": jnp.float32(-rng.rand()), "high": jnp.float32(1.0 + rng.rand())}  # noqa: E731
    state = {"params": params, "opt": opt, "moments": {"task": moments(), "exploration": {k: moments() for k in CRITICS}}}
    fabric = Fabric(devices=1, accelerator="cpu", precision="bf16-mixed")
    train_fn = jax_expl.build_train_fn(wm, actor, critic, member, txs, jcfg, fabric, ACTIONS, False)
    return jcfg, jax.device_get(params), state, train_fn, member


def _torch_side(params, moments):
    cfg = port_compose(overrides=["exp=p2e_dv3_exploration", "metric.log_level=0"] + OVERRIDES)
    modules = build_agent(cfg, ACTIONS, False, {"state": (STATE,)}, device="cpu")
    state_dicts, skipped = convert_p2e_dv3(params, training=True)
    assert skipped == []
    names = ("world_model", "actor_task", "critic_task", "target_critic_task", "actor_exploration")
    for name, module in zip(names, modules):
        module.load_state_dict(state_dicts[name])
    for k, pair in modules[5].items():
        for part in ("module", "target"):
            pair[part].load_state_dict(state_dicts["critics_exploration"][k][part])
    modules[6].load_state_dict(state_dicts["ensembles"])
    state = build_optimizers_and_state(cfg, *modules)
    for k, v in state["moments"]["task"].items():
        v.fill_(float(moments["task"][k]))
    for name, m in state["moments"]["exploration"].items():
        for k, v in m.items():
            v.fill_(float(moments["exploration"][name][k]))
    return cfg, state


def _assert_step(module, opt, mu_sd, after_sd, lr, what):
    """The first moment within the gradient tolerance, then the parameters
    within 2% of the learning rate, ``2·lr`` more where the gradient is
    within that tolerance of zero; every parameter f32."""
    for pname, p in module.named_parameters():
        assert p.dtype == torch.float32, f"{what}.{pname}"
        want = mu_sd[pname].numpy() / 0.1
        got = opt.state[p]["exp_avg"].numpy() / 0.1
        grad_atol = GRAD_ATOL_OF_MAX * max(float(np.abs(want).max()), 1e-6)
        np.testing.assert_allclose(got, want, rtol=0, atol=grad_atol, err_msg=f"{what}.{pname} gradient")
        norm_err = float(np.linalg.norm(got - want)) / max(float(np.linalg.norm(want)), 1e-12)
        assert norm_err <= GRAD_NORM_RTOL, f"{what}.{pname} gradient: {norm_err} of its norm apart"
        atol = np.where(np.abs(want) <= grad_atol, 2.0 * lr + 0.02 * lr, 0.02 * lr)
        err = np.abs(p.detach().numpy() - after_sd[pname].numpy())
        assert (err <= atol).all(), f"{what}.{pname}: max error {err.max()}"


def test_exploration_step_bf16_matches_jax():
    jcfg, params, jstate, train_fn, member = _jax_side()
    key, batch, tau = jax.random.PRNGKey(11), _batch(), 0.02
    new_state, j_metrics = train_fn(jax.tree_util.tree_map(jnp.array, jstate),
                                    {k: jnp.asarray(v) for k, v in batch.items()}, key, jnp.float32(tau))
    new_state, j_metrics = jax.device_get(new_state), jax.device_get(j_metrics)

    cfg, state = _torch_side(params, jax.device_get(jstate["moments"]))
    assert state["world_model"].rssm.recurrent_model.gru.dtype == torch.bfloat16
    metrics = build_train_fn(cfg, ACTIONS, False)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, _jax_noise(key), tau=tau
    )
    assert set(metrics) == set(j_metrics)
    for name, value in metrics.items():
        np.testing.assert_allclose(float(value), float(j_metrics[name]), **METRIC_TOL, err_msg=name)

    jparams, opt = new_state["params"], new_state["opt"]
    after, _ = convert_p2e_dv3(jparams, training=True)
    a = cfg.algo
    lrs = {"world_model": a.world_model.optimizer.lr, "ensembles": a.ensembles.optimizer.lr,
           "actor_exploration": a.actor.optimizer.lr, "actor_task": a.actor.optimizer.lr,
           "critic_task": a.critic.optimizer.lr}
    for name, lr in lrs.items():
        mu, _ = convert_p2e_dv3({**jparams, name: _first_moments(opt[name])}, training=True)
        _assert_step(state[name], state["opt"][name], mu[name], after[name], float(lr), name)
    for k in CRITICS:
        tree = {**jparams, "critics_exploration": {**jparams["critics_exploration"]}}
        tree["critics_exploration"][k] = {"module": _first_moments(opt["critics_exploration"][k]),
                                          "target": jparams["critics_exploration"][k]["target"]}
        mu, _ = convert_p2e_dv3(tree, training=True)
        _assert_step(state["critics_exploration"][k]["module"], state["opt"]["critics_exploration"][k],
                     mu["critics_exploration"][k]["module"], after["critics_exploration"][k]["module"],
                     float(a.critic.optimizer.lr), f"critics_exploration.{k}")
    for k in ("low", "high"):
        np.testing.assert_allclose(float(state["moments"]["task"][k]), float(new_state["moments"]["task"][k]),
                                   rtol=16 * BF16, atol=1e-6)


def test_ensemble_stays_f32_under_bf16():
    """The ensemble takes no compute dtype: its parameters and outputs are
    f32 in a bf16-mixed build, and on an f32 input its forward is the JAX
    ensemble's at f32 tolerance, while the world model and both actors and
    critics compute in bf16."""
    jcfg, params, _jstate, _train_fn, member = _jax_side()
    cfg, state = _torch_side(params, {"task": {"low": 0.0, "high": 0.0},
                                      "exploration": {k: {"low": 0.0, "high": 0.0} for k in CRITICS}})
    ens = state["ensembles"]
    assert all(p.dtype == torch.float32 for p in ens.parameters())
    x = np.random.RandomState(4).randn(HORIZON + 1, 5, ens.input_dim).astype(np.float32)
    want = np.asarray(jax_agent.apply_ensemble(member, params["ensembles"], jnp.asarray(x)))
    with torch.no_grad():
        got = ens(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    for name in ("actor_task", "actor_exploration"):
        assert all(h.compute_dtype == torch.bfloat16 for h in state[name].heads)
    assert state["critics_exploration"][CRITICS[0]]["module"].head.compute_dtype == torch.bfloat16

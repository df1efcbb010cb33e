"""The port's Plan2Explore on DreamerV2 against the JAX package on the CPU.

The JAX ``build_agent``'s weights at a small width (each target critic at
half its critic, so that ``τ`` decides which one the actors see) carried
across by ``convert_p2e_dv2(..., training=True)``; the same batch; the
noise the JAX step draws from its key re-derived with its key schedule
(``fold_in`` of the data-axis index, ``split`` into the world-model,
exploration and task keys, each imagination's prior key and a key a step,
one key a head) and handed to the port as tensors. Discrete actions (the
MsPacman preset's pixels and 9 actions).

Tolerances, those of ``test_torch_dreamer_v2_train.py`` (float32 on the
CPU, another summation order): every loss and metric rtol 1e-4, atol 1e-6;
each optimizer's first moment rtol 1e-3, atol 1e-5; parameters and targets
after the step atol 2e-6, and ``2·lr`` more where the JAX gradient lies
within that gradient tolerance of zero (its sign there is float32 rounding,
and Adam's first step moves such an element by up to ``lr`` either way);
the ensemble's forward, the intrinsic reward and the ensemble loss (a unit
Gaussian against the next posterior) rtol 1e-5, atol 1e-6.
"""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_jit_build import jit_build

from sheeprl_tpu.algos.p2e_dv2 import agent as jax_agent
from sheeprl_tpu.algos.p2e_dv2 import p2e_dv2_exploration as jax_expl
from sheeprl_tpu.config import compose
from sheeprl_tpu.config.instantiate import instantiate as jax_instantiate
from sheeprl_tpu.distributions import Independent as JaxIndependent
from sheeprl_tpu.distributions import Normal as JaxNormal
from sheeprl_tpu.fabric import Fabric
from sheeprl_tpu_torch.algos.p2e_dv2.agent import build_agent
from sheeprl_tpu_torch.algos.p2e_dv2.p2e_dv2_exploration import (
    build_losses,
    build_optimizers_and_state,
    build_train_fn,
)
from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_exploration import intrinsic_reward
from sheeprl_tpu_torch.config import compose as port_compose
from sheeprl_tpu_torch.convert import convert_p2e_dv2

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
OVERRIDES = [f"{k}={v}" for k, v in SMALL.items()]
T, B, HORIZON, S, D = 4, 3, 3, 4, 4
ACTIONS = (9,)
METRIC_TOL = dict(rtol=1e-4, atol=1e-6)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
PARAM_ATOL = 0.01 * 2e-4
FN_TOL = dict(rtol=1e-5, atol=1e-6)
TRAINED = ("world_model", "ensembles", "actor_exploration", "critic_exploration", "actor_task", "critic_task")
MODULES = TRAINED + ("target_critic_task", "target_critic_exploration")


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
    is_first[2, 2] = 1.0  # row 2 starts a new episode after its done
    return {
        "rgb": rng.randint(0, 256, (T, B, 3, 64, 64)).astype(np.uint8),
        "actions": np.eye(ACTIONS[0], dtype=np.float32)[rng.randint(0, ACTIONS[0], (T, B))],
        "rewards": rng.randn(T, B, 1).astype(np.float32),
        "dones": dones,
        "is_first": is_first,
    }


def _imagination_noise(key):
    """One JAX DreamerV2 imagination's noise: the prior Gumbels' key, then a
    key a step, split per head."""
    k_gum, k_steps = jax.random.split(key)
    prior = jax.random.gumbel(k_gum, (HORIZON, T * B, S, D))
    heads = [[] for _ in ACTIONS]
    for k in jax.random.split(k_steps, HORIZON):
        for j, kh in enumerate(jax.random.split(k, len(ACTIONS))):
            heads[j].append(np.asarray(jax.random.gumbel(kh, (T * B, ACTIONS[j]))))
    return torch.from_numpy(np.array(prior)), [torch.from_numpy(np.stack(h)) for h in heads]


def _jax_noise(key):
    """The JAX step's noise: ``fold_in(key, 0)``, ``split`` into the world
    model's, the exploration actor's and the task actor's keys."""
    key = jax.random.fold_in(key, 0)  # the data-axis index of the single device
    k_wm, k_expl, k_task = jax.random.split(key, 3)
    expl_prior, expl_actions = _imagination_noise(k_expl)
    prior, actions = _imagination_noise(k_task)
    return {
        "posterior": torch.from_numpy(np.array(jax.random.gumbel(k_wm, (T, B, S, D)))),
        "prior": prior, "actions": actions, "exploration_prior": expl_prior, "exploration_actions": expl_actions,
    }


def _first_moments(opt_state):
    """The ``mu`` tree of an optax chain(clip, inject_hyperparams(adamw)) state."""
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
    jcfg = compose(overrides=["exp=p2e_dv2_exploration", "env=dummy", "metric.log_level=0"] + OVERRIDES)
    space = gym.spaces.Dict({"rgb": gym.spaces.Box(0, 255, (3, 64, 64), np.uint8)})
    wm, actor, critic, member, params = jit_build(jax_agent.build_agent, jcfg, ACTIONS, False, space, jax.random.PRNGKey(3))
    half = lambda t: jax.tree_util.tree_map(lambda p: 0.5 * p, t)  # noqa: E731
    params["target_critic_task"] = half(params["critic_task"])
    params["target_critic_exploration"] = half(params["critic_exploration"])
    a = jcfg.algo
    groups = {"world_model": a.world_model, "ensembles": a.ensembles, "actor_task": a.actor, "critic_task": a.critic,
              "actor_exploration": a.actor, "critic_exploration": a.critic}
    txs = {name: jax_instantiate(g.optimizer, max_grad_norm=g.clip_gradients) for name, g in groups.items()}
    state = {"params": params, "opt": {name: tx.init(params[name]) for name, tx in txs.items()}}
    train_fn = jax_expl.build_train_fn(wm, actor, critic, member, txs, jcfg, Fabric(devices=1, accelerator="cpu"),
                                       ACTIONS, False)
    return dict(params=jax.device_get(params), state=jax.device_get(state), train_fn=train_fn, member=member)


def _torch_side(params):
    cfg = port_compose(overrides=["exp=p2e_dv2_exploration", "metric.log_level=0"] + OVERRIDES)
    modules = build_agent(cfg, ACTIONS, False, {"rgb": (3, 64, 64)}, device="cpu")
    state_dicts, skipped = convert_p2e_dv2(params, training=True)
    assert skipped == []
    names = ("world_model", "actor_task", "critic_task", "target_critic_task", "actor_exploration",
             "critic_exploration", "target_critic_exploration", "ensembles")
    for name, module in zip(names, modules):
        module.load_state_dict(state_dicts[name])
    return cfg, build_optimizers_and_state(cfg, *modules)


@pytest.mark.parametrize("tau", [0.0, 1.0])
def test_exploration_step_matches_jax(jax_side, tau):
    """One whole exploration step: the six updates' losses, metrics and
    gradients, and the parameters and both targets after it."""
    key = jax.random.PRNGKey(11)
    batch = _batch()
    state0 = jax.tree_util.tree_map(jnp.array, jax_side["state"])  # the step donates its state
    new_state, j_metrics = jax_side["train_fn"](state0, {k: jnp.asarray(v) for k, v in batch.items()}, key,
                                                jnp.float32(tau))
    new_state, j_metrics = jax.device_get(new_state), jax.device_get(j_metrics)

    cfg, state = _torch_side(jax_side["params"])
    metrics = build_train_fn(cfg, ACTIONS, False)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, _jax_noise(key), tau=tau
    )
    assert set(metrics) == set(j_metrics)
    for name, value in metrics.items():
        np.testing.assert_allclose(float(value), float(j_metrics[name]), **METRIC_TOL, err_msg=name)

    params = new_state["params"]
    after, _ = convert_p2e_dv2(params, training=True)
    grads = {}
    for name in TRAINED:
        mu, _ = convert_p2e_dv2({**params, name: _first_moments(new_state["opt"][name])}, training=True)
        grads[name] = {}
        for pname, p in state[name].named_parameters():
            want = grads[name][pname] = mu[name][pname].numpy() / 0.1
            np.testing.assert_allclose(state["opt"][name].state[p]["exp_avg"].numpy() / 0.1, want, **GRAD_TOL,
                                       err_msg=f"{name}.{pname} gradient")
    for name in MODULES:
        lr = float(state["opt"][name].param_groups[0]["lr"]) if name in TRAINED else 0.0
        for pname, value in state[name].state_dict().items():
            want = after[name][pname].numpy()
            atol = np.full(want.shape, PARAM_ATOL, np.float32)
            if name in TRAINED:
                atol[np.abs(grads[name][pname]) <= GRAD_TOL["atol"]] += 2 * lr
            err = np.abs(value.numpy() - want)
            assert (err <= atol).all(), f"{name}.{pname}: max error {err.max()}"


def test_ensemble_intrinsic_reward_and_loss_match_jax(jax_side):
    """The stacked ensemble (no LayerNorm, with biases, ELU) on a shared
    input, the intrinsic reward (population variance over members) and the
    ensemble loss (a unit Gaussian against the next posterior)."""
    cfg, state = _torch_side(jax_side["params"])
    ens = state["ensembles"]
    assert ens.mlp.blocks[0].norm is None and ens.mlp.blocks[0].linear.bias is not None
    rng = np.random.RandomState(4)
    x = rng.randn(HORIZON + 1, 5, ens.input_dim).astype(np.float32)
    want = np.asarray(jax_agent.apply_ensemble(jax_side["member"], jax_side["params"]["ensembles"], jnp.asarray(x)))
    with torch.no_grad():
        got = ens(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **FN_TOL)
    want_r = np.asarray(jnp.var(jnp.asarray(want), axis=0).mean(-1, keepdims=True) * 0.5)
    split = S * D + 32
    got_r = intrinsic_reward(ens, torch.from_numpy(x[..., :split]), torch.from_numpy(x[..., split:]), 0.5)
    np.testing.assert_allclose(got_r.numpy(), want_r, **FN_TOL)

    post = rng.randn(T, B, S * D).astype(np.float32)
    rec = rng.randn(T, B, 32).astype(np.float32)
    act = rng.randn(T, B, ACTIONS[0]).astype(np.float32)
    out = jax_agent.apply_ensemble(jax_side["member"], jax_side["params"]["ensembles"],
                                   jnp.concatenate([post, rec, act], -1))[:, :-1]
    dist = JaxIndependent(JaxNormal(out, jnp.ones_like(out)), 1)
    want_loss = -jnp.sum(jnp.mean(dist.log_prob(jnp.asarray(post[1:])[None]), axis=(1, 2)))
    loss = build_losses(cfg, ACTIONS, False).ensemble_loss(
        ens, torch.from_numpy(post), torch.from_numpy(rec), torch.from_numpy(act)
    )
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), **FN_TOL)


def test_converter_serving_and_unknown_trees(jax_side):
    params = jax_side["params"]
    served, skipped = convert_p2e_dv2(params)
    assert set(served) == {"world_model", "actor_task"}
    assert any(p.startswith("ensembles/MLP_0/Dense_0/") for p in skipped)
    assert any(p.startswith("target_critic_exploration/") for p in skipped)
    with pytest.raises(KeyError, match="unknown param tree"):
        convert_p2e_dv2({**params, "critics_exploration": {}}, training=True)
    missing = {k: v for k, v in params.items() if k != "critic_exploration"}
    with pytest.raises(KeyError, match="missing"):
        convert_p2e_dv2(missing, training=True)

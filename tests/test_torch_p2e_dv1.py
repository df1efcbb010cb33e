"""The port's Plan2Explore on DreamerV1 against the JAX package on the CPU.

The JAX ``build_agent``'s weights at a small width carried across by
``convert_p2e_dv1(..., training=True)``; the same batch (with an episode
boundary inside it); the noise the JAX step draws from its key re-derived
with its key schedule (``fold_in`` of the data-axis index, ``split`` into
the world-model, exploration and task keys; the posterior's standard
normals; each imagination's prior key and a key a step, one key a head,
Gumbels) and handed to the port as tensors. Discrete actions on pixels and
a vector, so that the ensemble's target, the next observation embedding,
holds both encoders' features; free nats 0, so that the KL is live.

Tolerances, those of ``test_torch_dreamer_v2_train.py`` (float32 on the
CPU, another summation order): every loss and metric rtol 1e-4, atol 1e-6;
each optimizer's first moment rtol 1e-3, atol 1e-5; parameters after the
step atol 2e-6, and ``2·lr`` more where the JAX gradient lies within that
gradient tolerance of zero (Adam's first step moves such an element by up
to ``lr`` either way); the ensemble's forward, the intrinsic reward and the
ensemble loss rtol 1e-5, atol 1e-6.
"""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v1 import dreamer_v1 as jax_dv1
from sheeprl_tpu.algos.p2e_dv1 import agent as jax_agent
from sheeprl_tpu.algos.p2e_dv1 import p2e_dv1_exploration as jax_expl
from sheeprl_tpu.config import compose
from sheeprl_tpu.config.instantiate import instantiate as jax_instantiate
from sheeprl_tpu.distributions import Independent as JaxIndependent
from sheeprl_tpu.distributions import Normal as JaxNormal
from sheeprl_tpu.fabric import Fabric
from sheeprl_tpu_torch.algos.dreamer_v1 import dreamer_v1 as dv1
from sheeprl_tpu_torch.algos.dreamer_v1.agent import build_agent as dv1_build_agent
from sheeprl_tpu_torch.algos.p2e_dv1.agent import build_agent, embedding_dim
from sheeprl_tpu_torch.algos.p2e_dv1.p2e_dv1_exploration import (
    build_optimizers_and_state,
    build_train_fn,
    ensemble_loss,
)
from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_exploration import intrinsic_reward
from sheeprl_tpu_torch.config import compose as port_compose
from sheeprl_tpu_torch.convert import convert_p2e_dv1
from test_torch_dreamer_v2_train import _first_moments

SMALL = {
    "algo.dense_units": 16,
    "algo.mlp_layers": 1,
    "algo.world_model.encoder.cnn_channels_multiplier": 2,
    "algo.world_model.recurrent_model.recurrent_state_size": 12,
    "algo.world_model.stochastic_size": 4,
    "algo.world_model.transition_model.hidden_size": 10,
    "algo.world_model.representation_model.hidden_size": 10,
    "algo.world_model.kl_free_nats": 0.0,
    "algo.horizon": 3,
    "algo.ensembles.n": 3,
    "per_rank_batch_size": 3,
    "per_rank_sequence_length": 4,
    "mlp_keys.encoder": ["state"],
    "mlp_keys.decoder": ["state"],
}
OVERRIDES = [f"{k}={v}" for k, v in SMALL.items()]
T, B, HORIZON, S, REC = 4, 3, 3, 4, 12
ACTIONS = (3,)
OBS = {"rgb": (3, 64, 64), "state": (5,)}
#: each with its own optimizer, in the port's layout
MODULES = ("world_model", "ensembles", "actor_exploration", "critic_exploration", "actor_task", "critic_task")
METRIC_TOL = dict(rtol=1e-4, atol=1e-6)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
PARAM_ATOL = 2e-6
FN_TOL = dict(rtol=1e-5, atol=1e-6)


def _batch(seed=21):
    rng = np.random.RandomState(seed)
    dones = np.zeros((T, B, 1), np.float32)
    dones[1, 2] = 1.0
    actions = np.eye(ACTIONS[0], dtype=np.float32)[rng.randint(0, ACTIONS[0], (T, B))]
    actions[2, 2] = 0.0  # the next episode's first row
    return {
        "rgb": rng.randint(0, 256, (T, B) + OBS["rgb"]).astype(np.uint8),
        "state": rng.uniform(-1, 1, (T, B) + OBS["state"]).astype(np.float32),
        "actions": actions,
        "rewards": rng.randn(T, B, 1).astype(np.float32),
        "dones": dones,
    }


def _imagination_noise(key):
    k_eps, k_steps = jax.random.split(key)
    prior = np.array(jax.random.normal(k_eps, (HORIZON, T * B, S)))
    heads = [[] for _ in ACTIONS]
    for k in jax.random.split(k_steps, HORIZON):
        for j, kh in enumerate(jax.random.split(k, len(ACTIONS))):
            heads[j].append(np.array(jax.random.gumbel(kh, (T * B, ACTIONS[j]))))
    return torch.from_numpy(prior), [torch.from_numpy(np.stack(h)) for h in heads]


def _jax_noise(key):
    k_wm, k_expl, k_task = jax.random.split(jax.random.fold_in(key, 0), 3)
    noise = {"posterior": torch.from_numpy(np.array(jax.random.normal(k_wm, (T, B, S))))}
    noise["exploration_prior"], noise["exploration_actions"] = _imagination_noise(k_expl)
    noise["prior"], noise["actions"] = _imagination_noise(k_task)
    return noise


def _space():
    return gym.spaces.Dict({"rgb": gym.spaces.Box(0, 255, OBS["rgb"], np.uint8),
                            "state": gym.spaces.Box(-1, 1, OBS["state"], np.float32)})


@pytest.fixture(scope="module")
def jax_side():
    jcfg = compose(overrides=["exp=p2e_dv1_exploration", "env=dummy", "metric.log_level=0"] + OVERRIDES)
    wm, actor, critic, member, params = jax_agent.build_agent(jcfg, ACTIONS, False, _space(), jax.random.PRNGKey(3))
    a = jcfg.algo
    groups = {"world_model": a.world_model, "ensembles": a.ensembles, "actor_task": a.actor, "critic_task": a.critic,
              "actor_exploration": a.actor, "critic_exploration": a.critic}
    txs = {name: jax_instantiate(g.optimizer, max_grad_norm=g.clip_gradients) for name, g in groups.items()}
    state = {"params": params, "opt": {name: tx.init(params[name]) for name, tx in txs.items()}}
    train_fn = jax_expl.build_train_fn(wm, actor, critic, member, txs, jcfg, Fabric(devices=1, accelerator="cpu"),
                                       ACTIONS, False)
    return dict(params=jax.device_get(params), state=jax.device_get(state), train_fn=train_fn, member=member,
                jcfg=jcfg, wm=wm, actor=actor, critic=critic)


def _port_cfg(*extra):
    return port_compose(overrides=["exp=p2e_dv1_exploration", "metric.log_level=0"] + OVERRIDES + list(extra))


def _torch_side(params):
    cfg = _port_cfg()
    modules = build_agent(cfg, ACTIONS, False, OBS, device="cpu")
    state_dicts, skipped = convert_p2e_dv1(params, training=True)
    assert skipped == []
    names = ("world_model", "actor_task", "critic_task", "actor_exploration", "critic_exploration", "ensembles")
    for name, module in zip(names, modules):
        module.load_state_dict(state_dicts[name])
    return cfg, build_optimizers_and_state(cfg, *modules)


def _check_updates(state, new_state, modules, convert):
    """Each module's first moment against optax's and its parameters after the step."""
    params = new_state["params"]
    after = convert(params)
    for name in modules:
        mu = convert({**params, name: _first_moments(new_state["opt"][name])})[name]
        lr = float(state["opt"][name].param_groups[0]["lr"])
        for pname, p in state[name].named_parameters():
            want = mu[pname].numpy() / 0.1
            np.testing.assert_allclose(state["opt"][name].state[p]["exp_avg"].numpy() / 0.1, want, **GRAD_TOL,
                                       err_msg=f"{name}.{pname} gradient")
            atol = np.where(np.abs(want) <= GRAD_TOL["atol"], PARAM_ATOL + 2 * lr, PARAM_ATOL)
            err = np.abs(p.detach().numpy() - after[name][pname].numpy())
            assert (err <= atol).all(), f"{name}.{pname}: max error {err.max()}"


def test_exploration_step_matches_jax(jax_side):
    """One whole exploration step: the four pairs of updates' losses,
    metrics (the intrinsic reward among them) and gradients, and every
    module's parameters after it."""
    key = jax.random.PRNGKey(11)
    batch = _batch()
    state0 = jax.tree_util.tree_map(jnp.array, jax_side["state"])  # the step donates its state
    new_state, j_metrics = jax.device_get(
        jax_side["train_fn"](state0, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    )
    cfg, state = _torch_side(jax_side["params"])
    metrics = build_train_fn(cfg, ACTIONS, False)(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                                                  _jax_noise(key))
    assert set(metrics) == set(j_metrics)
    for name, value in metrics.items():
        np.testing.assert_allclose(float(value), float(j_metrics[name]), **METRIC_TOL, err_msg=name)
    assert float(metrics["Rewards/intrinsic"]) > 0.0
    assert all(float(metrics[f"Grads/{n}"]) > 0.0 for n in ("ensemble", "actor_exploration", "actor_task"))
    _check_updates(state, new_state, MODULES, lambda p: convert_p2e_dv1(p, training=True)[0])


def test_ensemble_intrinsic_reward_and_loss_match_jax(jax_side):
    """The stacked ensemble (no LayerNorm, with biases, ELU) on a shared
    input, its width the embedding's (the CNN's features and the MLP
    encoder's), the intrinsic reward (population variance over members) and
    the ensemble loss (a unit Gaussian against the next embedding)."""
    _cfg, state = _torch_side(jax_side["params"])
    ens = state["ensembles"]
    E = embedding_dim(_cfg, ["rgb"], ["state"])
    assert ens.output_dim == E == 2 * 8 * 2 * 2 + 16 and ens.mlp.blocks[0].norm is None
    rng = np.random.RandomState(4)
    x = rng.randn(HORIZON, 5, ens.input_dim).astype(np.float32)
    want = np.asarray(jax_agent.apply_ensemble(jax_side["member"], jax_side["params"]["ensembles"], jnp.asarray(x)))
    with torch.no_grad():
        got = ens(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **FN_TOL)
    want_r = np.asarray(jnp.var(jnp.asarray(want), axis=0).mean(-1, keepdims=True) * 1e4)
    split = S + REC
    got_r = intrinsic_reward(ens, torch.from_numpy(x[..., :split]), torch.from_numpy(x[..., split:]), 1e4)
    np.testing.assert_allclose(got_r.numpy(), want_r, **FN_TOL)

    post, rec = rng.randn(T, B, S).astype(np.float32), rng.randn(T, B, REC).astype(np.float32)
    act, emb = rng.randn(T, B, ACTIONS[0]).astype(np.float32), rng.randn(T, B, E).astype(np.float32)
    out = jax_agent.apply_ensemble(jax_side["member"], jax_side["params"]["ensembles"],
                                   jnp.concatenate([post, rec, act], -1))[:, :-1]
    dist = JaxIndependent(JaxNormal(out, jnp.ones_like(out)), 1)
    want_loss = -jnp.sum(jnp.mean(dist.log_prob(jnp.asarray(emb[1:])[None]), axis=(1, 2)))
    t = torch.from_numpy
    loss = ensemble_loss(ens, t(post), t(rec), t(act), t(emb))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), **FN_TOL)


def test_finetuning_step_matches_jax(jax_side):
    """The finetuning phase's step: DreamerV1's step on the exploration
    checkpoint's world model, task actor and task critic (the JAX
    finetuning's ``{world_model, actor: actor_task, critic: critic_task}``),
    fresh optimizers."""
    params = jax_side["params"]
    task = {"world_model": params["world_model"], "actor": params["actor_task"], "critic": params["critic_task"]}
    jcfg = compose(overrides=["exp=p2e_dv1_finetuning", "env=dummy", "metric.log_level=0",
                              "checkpoint.exploration_ckpt_path=unused"] + OVERRIDES)
    world_tx, actor_tx, critic_tx, jstate = jax_dv1.build_optimizers_and_state(jcfg, task)
    train_fn = jax_dv1.build_train_fn(jax_side["wm"], jax_side["actor"], jax_side["critic"], world_tx, actor_tx,
                                      critic_tx, jcfg, Fabric(devices=1, accelerator="cpu"), ACTIONS, False)
    key, batch = jax.random.PRNGKey(13), _batch(22)
    new_state, j_metrics = jax.device_get(train_fn(jax.tree_util.tree_map(jnp.array, jax.device_get(jstate)),
                                                   {k: jnp.asarray(v) for k, v in batch.items()}, key))

    cfg = _port_cfg("exp=p2e_dv1_finetuning", "checkpoint.exploration_ckpt_path=unused")
    modules = dv1_build_agent(cfg, ACTIONS, False, OBS, device="cpu", training=True)
    trees, _ = convert_p2e_dv1(params, training=True)
    for module, tree in zip(modules, ("world_model", "actor_task", "critic_task")):
        module.load_state_dict(trees[tree])
    state = dv1.build_optimizers_and_state(cfg, *modules)
    k_wm, k_img = jax.random.split(jax.random.fold_in(key, 0))
    noise = {"posterior": torch.from_numpy(np.array(jax.random.normal(k_wm, (T, B, S))))}
    noise["prior"], noise["actions"] = _imagination_noise(k_img)
    metrics = dv1.build_train_fn(cfg, ACTIONS, False)(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                                                      noise)
    assert set(metrics) == set(j_metrics)
    for name, value in metrics.items():
        np.testing.assert_allclose(float(value), float(j_metrics[name]), **METRIC_TOL, err_msg=name)
    names = {"world_model": "world_model", "actor": "actor_task", "critic": "critic_task"}

    def convert(p):
        trees = convert_p2e_dv1({**params, **{names[k]: v for k, v in p.items() if k in names}}, training=True)[0]
        return {k: trees[v] for k, v in names.items()}

    _check_updates(state, new_state, tuple(names), convert)


def test_converter_serving_and_unknown_trees(jax_side):
    params = jax_side["params"]
    served, skipped = convert_p2e_dv1(params)
    assert set(served) == {"world_model", "actor_task"}
    assert any(p.startswith("ensembles/MLP_0/Dense_0/") for p in skipped)
    assert any(p.startswith("critic_exploration/") for p in skipped)
    with pytest.raises(KeyError, match="unknown param tree"):
        convert_p2e_dv1({**params, "target_critic_task": params["critic_task"]}, training=True)
    missing = {k: v for k, v in params.items() if k != "critic_exploration"}
    with pytest.raises(KeyError, match="missing"):
        convert_p2e_dv1(missing, training=True)

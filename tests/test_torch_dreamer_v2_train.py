"""The port's DreamerV2 training slice against the JAX package on the CPU.

One whole gradient step of each side at a small width, from the same
weights (the JAX ``build_agent``'s, carried across by
``convert_dreamer_v2(..., training=True)``), the same batch and the same
noise: the JAX step draws its Gumbel noise from its key inside the jitted
program, and this test re-derives that noise with JAX's own key schedule
(``fold_in`` of the data-axis index, then ``split`` into the world-model
and imagination keys; posterior Gumbels; prior Gumbels and one key per
imagination step; ``split`` per actor head; ``jax.random.categorical``'s
Gumbels) and hands it to the port as tensors. Seeds are never matched
across the frameworks.

Tolerances (float32 on the CPU; XLA and PyTorch sum in different orders):

- every loss and metric: rtol 1e-4, atol 1e-6 (the atol covers metrics
  that are means of signed values near 0);
- gradients per module, read from the optimizers' first moments after the
  step (both are ``(1 - β1)·clipped gradient`` after one Adam step):
  rtol 1e-3, atol 1e-5;
- updated parameters: atol 2e-6, 1% of the world model's learning rate
  (an Adam step moves a parameter by up to the learning rate);
- λ-returns, the reconstruction loss and the KL: rtol 1e-5, atol 1e-6.
"""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_jit_build import jit_build

from sheeprl_tpu.algos.dreamer_v2 import agent as jax_agent
from sheeprl_tpu.algos.dreamer_v2 import dreamer_v2 as jax_dv2
from sheeprl_tpu.algos.dreamer_v2.loss import categorical_kl as jax_categorical_kl
from sheeprl_tpu.algos.dreamer_v2.loss import reconstruction_loss as jax_reconstruction_loss
from sheeprl_tpu.algos.dreamer_v2.utils import compute_lambda_values as jax_lambda_values
from sheeprl_tpu.config import compose
from sheeprl_tpu.distributions import Bernoulli as JaxBernoulli
from sheeprl_tpu.distributions import Independent as JaxIndependent
from sheeprl_tpu.distributions import Normal as JaxNormal
from sheeprl_tpu.distributions import OneHotCategoricalStraightThrough as JaxStraightThrough
from sheeprl_tpu.fabric import Fabric
from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_agent
from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import build_optimizers_and_state, build_train_fn
from sheeprl_tpu_torch.algos.dreamer_v2.loss import categorical_kl, reconstruction_loss
from sheeprl_tpu_torch.algos.dreamer_v2.utils import compute_lambda_values
from sheeprl_tpu_torch.configs import dreamer_v2_config
from sheeprl_tpu_torch.convert import convert_dreamer_v2
from sheeprl_tpu_torch.distributions import Bernoulli, Independent, Normal, OneHotCategoricalStraightThrough

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
ACTIONS = (9,)
METRIC_TOL = dict(rtol=1e-4, atol=1e-6)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
PARAM_ATOL = 0.01 * 2e-4
FN_TOL = dict(rtol=1e-5, atol=1e-6)


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


def _batch():
    rng = np.random.RandomState(21)
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


def _jax_noise(key):
    """The JAX step's Gumbel noise, re-derived from its key as
    ``dreamer_v2.py`` and ``dreamer_v3/agent.py`` split it."""
    key = jax.random.fold_in(key, 0)  # the data-axis index of the single device
    k_wm, k_img = jax.random.split(key)
    posterior = jax.random.gumbel(k_wm, (T, B, S, D))
    k_gum, k_steps = jax.random.split(k_img)
    prior = jax.random.gumbel(k_gum, (HORIZON, T * B, S, D))
    step_keys = jax.random.split(k_steps, HORIZON)
    heads = [[] for _ in ACTIONS]
    for k in step_keys:
        for j, kh in enumerate(jax.random.split(k, len(ACTIONS))):
            heads[j].append(jax.random.gumbel(kh, (T * B, ACTIONS[j])))
    return {
        "posterior": torch.from_numpy(np.array(posterior)),
        "prior": torch.from_numpy(np.array(prior)),
        "actions": [torch.from_numpy(np.stack([np.asarray(g) for g in h])) for h in heads],
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
    fabric = Fabric(devices=1, accelerator="cpu")
    jcfg = compose(
        overrides=["exp=dreamer_v2_ms_pacman", "metric.log_level=0"] + [f"{k}={v}" for k, v in SMALL.items()]
    )
    space = gym.spaces.Dict({"rgb": gym.spaces.Box(0, 255, (3, 64, 64), np.uint8)})
    wm, actor, critic, params = jit_build(jax_agent.build_agent, jcfg, ACTIONS, False, space, jax.random.PRNGKey(3))
    # a target critic that differs from the critic, so that tau decides which one the actor sees
    params["target_critic"] = jax.tree_util.tree_map(lambda p: 0.5 * p, params["target_critic"])
    txs = jax_dv2.build_optimizers_and_state(jcfg, params)
    train_fn = jax_dv2.build_train_fn(wm, actor, critic, *txs[:3], jcfg, fabric, ACTIONS, False)
    return dict(params=jax.device_get(params), state=jax.device_get(txs[3]), train_fn=train_fn)


def _torch_side(params):
    cfg = dreamer_v2_config(**SMALL)
    wm, actor, critic, target = build_agent(cfg, ACTIONS, False, {"rgb": (3, 64, 64)}, device="cpu", training=True)
    state_dicts, skipped = convert_dreamer_v2(params, training=True)
    assert skipped == []
    for name, module in (("world_model", wm), ("actor", actor), ("critic", critic), ("target_critic", target)):
        module.load_state_dict(state_dicts[name])
    return cfg, build_optimizers_and_state(cfg, wm, actor, critic, target)


def test_rederived_noise_gives_jax_own_samples():
    """A straight-through sample is ``one_hot(argmax(logits + gumbel(key,
    logits.shape)))`` in ``jax.random.categorical``: the re-derived noise
    reproduces JAX's own samples through the port's distribution."""
    logits = np.random.RandomState(2).randn(T * B, ACTIONS[0]).astype(np.float32)
    for kh in jax.random.split(jax.random.PRNGKey(9), 3):
        want = np.asarray(JaxStraightThrough(logits=jnp.asarray(logits)).rsample(kh))
        gumbel = torch.from_numpy(np.array(jax.random.gumbel(kh, logits.shape)))
        got = OneHotCategoricalStraightThrough(logits=torch.from_numpy(logits)).rsample(gumbel=gumbel).numpy()
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        np.testing.assert_allclose(got, want, **FN_TOL)


@pytest.mark.parametrize("tau", [0.0, 1.0])
def test_train_step_matches_jax(jax_side, tau):
    key = jax.random.PRNGKey(11)
    batch = _batch()
    state0 = jax.tree_util.tree_map(jnp.array, jax_side["state"])  # the step donates its state
    new_state, j_metrics = jax_side["train_fn"](
        state0, {k: jnp.asarray(v) for k, v in batch.items()}, key, jnp.float32(tau)
    )
    j_metrics = jax.device_get(j_metrics)
    new_state = jax.device_get(new_state)

    cfg, state = _torch_side(jax_side["params"])
    train_step = build_train_fn(cfg, ACTIONS, False)
    metrics = train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, _jax_noise(key), tau=tau)

    assert set(metrics) <= set(j_metrics)
    for name, value in metrics.items():
        np.testing.assert_allclose(float(value), float(j_metrics[name]), **METRIC_TOL, err_msg=name)

    after, _ = convert_dreamer_v2(new_state["params"], training=True)
    for name in ("world_model", "actor", "critic"):
        module, opt = state[name], state["opt"][name]
        moments, _ = convert_dreamer_v2(
            {**new_state["params"], name: _first_moments(new_state["opt"][name])}, training=True
        )
        for pname, p in module.named_parameters():
            np.testing.assert_allclose(
                opt.state[p]["exp_avg"].numpy() / 0.1, moments[name][pname].numpy() / 0.1, **GRAD_TOL,
                err_msg=f"{name}.{pname} gradient",
            )
    for name in ("world_model", "actor", "critic", "target_critic"):
        for pname, value in state[name].state_dict().items():
            np.testing.assert_allclose(
                value.numpy(), after[name][pname].numpy(), rtol=0, atol=PARAM_ATOL, err_msg=f"{name}.{pname}"
            )


def test_lambda_values_match_jax():
    rng = np.random.RandomState(4)
    r, v, c = (rng.randn(HORIZON, 6, 1).astype(np.float32) for _ in range(3))
    boot = rng.randn(1, 6, 1).astype(np.float32)
    want = np.asarray(jax_lambda_values(*(jnp.asarray(a) for a in (r, v, c)), bootstrap=jnp.asarray(boot), lmbda=0.95))
    got = compute_lambda_values(*(torch.from_numpy(a) for a in (r, v, c)), bootstrap=torch.from_numpy(boot), lmbda=0.95)
    np.testing.assert_allclose(got.numpy(), want, **FN_TOL)


def test_categorical_kl_matches_jax():
    rng = np.random.RandomState(5)
    p, q = (rng.randn(T, B, S, D).astype(np.float32) for _ in range(2))
    want = np.asarray(jax_categorical_kl(jnp.asarray(p), jnp.asarray(q)))
    got = categorical_kl(torch.from_numpy(p), torch.from_numpy(q))
    assert got.shape == (T, B)
    np.testing.assert_allclose(got.numpy(), want, **FN_TOL)


@pytest.mark.parametrize("kl_free_avg", [True, False])
def test_reconstruction_loss_matches_jax(kl_free_avg):
    """Soft continue targets ``(1 - done)·γ``: the port's Bernoulli takes
    them as the JAX one does."""
    rng = np.random.RandomState(6)
    recon, obs = (rng.randn(T, B, 3, 8, 8).astype(np.float32) for _ in range(2))
    reward_mean, rewards, cont = (rng.randn(T, B, 1).astype(np.float32) for _ in range(3))
    priors, posts = (rng.randn(T, B, S, D).astype(np.float32) for _ in range(2))
    targets = (1.0 - (rng.rand(T, B, 1) < 0.2)).astype(np.float32) * 0.995
    args = dict(kl_balancing_alpha=0.8, kl_free_nats=0.5, kl_free_avg=kl_free_avg, kl_regularizer=0.1,
                discount_scale_factor=0.5)
    j = lambda a: jnp.asarray(a)
    want_loss, want = jax_reconstruction_loss(
        {"rgb": JaxIndependent(JaxNormal(j(recon), jnp.ones_like(j(recon))), 3)}, {"rgb": j(obs)},
        JaxIndependent(JaxNormal(j(reward_mean), 1.0), 1), j(rewards), j(priors), j(posts),
        pc=JaxIndependent(JaxBernoulli(logits=j(cont)), 1), continue_targets=j(targets), **args,
    )
    t = torch.from_numpy
    loss, got = reconstruction_loss(
        {"rgb": Independent(Normal(t(recon), 1.0), 3)}, {"rgb": t(obs)},
        Independent(Normal(t(reward_mean), 1.0), 1), t(rewards), t(priors), t(posts),
        pc=Independent(Bernoulli(logits=t(cont)), 1), continue_targets=t(targets), **args,
    )
    np.testing.assert_allclose(float(loss), float(want_loss), **FN_TOL)
    for name, value in got.items():
        np.testing.assert_allclose(float(value), float(want[name]), **FN_TOL, err_msg=name)


def test_converter_consumes_every_leaf_of_a_full_width_tree():
    """A full ``exp=dreamer_v2_ms_pacman`` tree (world model with decoders
    and heads, actor, critic, target critic): every leaf is converted, and
    every state dict loads strictly into a full-width training build."""
    jcfg = compose(overrides=["exp=dreamer_v2_ms_pacman"])
    space = gym.spaces.Dict({"rgb": gym.spaces.Box(0, 255, (3, 64, 64), np.uint8)})
    params = jax.device_get(jit_build(jax_agent.build_agent, jcfg, ACTIONS, False, space, jax.random.PRNGKey(0))[3])
    state_dicts, skipped = convert_dreamer_v2(params, training=True)
    assert skipped == []
    assert sorted(state_dicts) == ["actor", "critic", "target_critic", "world_model"]
    for name in state_dicts:
        assert len(state_dicts[name]) == len(jax.tree_util.tree_leaves(params[name])), name
    modules = build_agent(dreamer_v2_config(), ACTIONS, False, {"rgb": (3, 64, 64)}, device="cpu", training=True)
    for name, module in zip(("world_model", "actor", "critic", "target_critic"), modules):
        module.load_state_dict(state_dicts[name])
        assert sum(p.numel() for p in module.state_dict().values()) == sum(
            np.asarray(a).size for a in jax.tree_util.tree_leaves(params[name])
        )
    params["critic"]["mystery"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="mystery"):
        convert_dreamer_v2(params, training=True)


def test_trainer_and_kernel_bench_run_on_the_cpu(monkeypatch):
    """The two entry points at a small width on the CPU, where the wrappers
    run their plain versions and count no launch."""
    from sheeprl_tpu_torch.tools import bench_dreamer, bench_kernels

    line = bench_dreamer.run(steps=1, device="cpu", **SMALL)
    assert line["device"] == "cpu" and line["hafner_cell_launches"] == 0
    assert all(np.isfinite(v) for v in line["losses"].values())
    monkeypatch.setattr(bench_kernels, "B", 2)
    monkeypatch.setattr(bench_kernels, "T", 3)
    monkeypatch.setattr(bench_kernels, "H", 8)
    monkeypatch.setattr(bench_kernels, "X", 4)
    line = bench_kernels.run("cpu", repeats=1)
    assert line["max_abs_err"] == 0.0 and line["grad_rel_err"] <= 1e-5 and line["value"] > 0

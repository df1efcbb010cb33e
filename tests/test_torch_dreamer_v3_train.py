"""The port's DreamerV3 training step against the JAX package on the CPU.

One whole gradient step of each side at a small width, and a two-step
burst, from the same weights (the JAX ``build_agent``'s, with the reward
and critic heads and the target critic moved off their initial values so
that every term of the losses is live, carried across by
``convert_dreamer_v3(..., training=True)``), the same batch and the same
noise: the JAX step draws its Gumbel noise from its key inside the jitted
program, and this test re-derives it with JAX's own key schedule
(``fold_in`` of the data-axis index, ``split`` into the world-model and
imagination keys; the posterior Gumbels; ``split`` into the first action's
key and the rest; one key per head for the first action; ``split`` into the
prior Gumbels' key and the step keys; one key per head each step) and hands
it to the port as tensors. Seeds are never matched across the frameworks.

Tolerances (float32 on the CPU; XLA and PyTorch sum in different orders):

- every loss and metric: rtol 1e-4, atol 1e-6;
- gradients per module, read from the optimizers' first moments after the
  step (both are ``(1 - β1)·clipped gradient`` after one Adam step):
  rtol 1e-3, atol 2e-5 of each gradient's largest magnitude. The pixel
  loss sums 12,288 squared errors a row, so the decoder's gradients reach
  about 20 before clipping, and at that scale float32 itself is the limit:
  the port's own float32 world-model gradient differs from its float64 one
  by 2.1e-4 on the decoder projection's bias (1.1e-5 of its largest
  element), so a fixed atol of 1e-5 is finer than either side computes;
- updated parameters and the target critic after one step: atol 1.6e-6,
  2% of the actor's learning rate (an Adam step moves a parameter by up to
  the learning rate); after the two-step burst atol 4e-6, 5%: the second
  Adam update ``m̂/(√v̂+ε)`` of two gradients that nearly cancel magnifies
  their float32 rounding (one element of the critic's LayerNorm bias read
  3.2e-6), so the burst also holds the first moments, linear in the
  gradients, to the gradient tolerance; the ``Moments`` state: rtol 1e-4,
  atol 1e-6;
- ``update_moments``, λ-returns, the KL and the reconstruction loss: rtol
  1e-5, atol 1e-6.
"""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v3 import agent as jax_agent
from sheeprl_tpu.algos.dreamer_v3 import dreamer_v3 as jax_dv3
from sheeprl_tpu.algos.dreamer_v3.loss import categorical_kl as jax_categorical_kl
from sheeprl_tpu.algos.dreamer_v3.loss import continue_distribution as jax_continue_distribution
from sheeprl_tpu.algos.dreamer_v3.loss import reconstruction_loss as jax_reconstruction_loss
from sheeprl_tpu.algos.dreamer_v3.utils import compute_lambda_values as jax_lambda_values
from sheeprl_tpu.algos.dreamer_v3.utils import update_moments as jax_update_moments
from sheeprl_tpu.config import compose
from sheeprl_tpu.distributions import MSEDistribution as JaxMSE
from sheeprl_tpu.distributions import SymlogDistribution as JaxSymlog
from sheeprl_tpu.distributions import TwoHotEncodingDistribution as JaxTwoHot
from sheeprl_tpu.fabric import Fabric
from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import build_optimizers_and_state, build_train_fn
from sheeprl_tpu_torch.algos.dreamer_v3.loss import categorical_kl, continue_distribution, reconstruction_loss
from sheeprl_tpu_torch.algos.dreamer_v3.utils import compute_lambda_values, init_moments, update_moments
from sheeprl_tpu_torch.configs import dreamer_v3_config
from sheeprl_tpu_torch.convert import convert_dreamer_v3
from sheeprl_tpu_torch.distributions import MSEDistribution, SymlogDistribution, TwoHotEncodingDistribution
from sheeprl_tpu_torch.train.burst import run_train_burst

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
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-3, 2e-5
PARAM_ATOL = 0.02 * 8e-5
BURST_PARAM_ATOL = 0.05 * 8e-5
FN_TOL = dict(rtol=1e-5, atol=1e-6)
MODULES = ("world_model", "actor", "critic", "target_critic")


def _batch(seed=21):
    rng = np.random.RandomState(seed)
    dones = np.zeros((T, B, 1), np.float32)
    dones[1, 2] = 1.0
    is_first = np.zeros((T, B, 1), np.float32)
    is_first[2, 2] = 1.0  # row 2 starts a new episode after its done
    return {
        "rgb": rng.randint(0, 256, (T, B, 3, 64, 64)).astype(np.uint8),
        "actions": np.eye(ACTIONS[0], dtype=np.float32)[rng.randint(0, ACTIONS[0], (T, B))],
        "rewards": (3.0 * rng.randn(T, B, 1)).astype(np.float32),
        "dones": dones,
        "is_first": is_first,
    }


def _jax_noise(key):
    """The JAX step's Gumbel noise, re-derived from its key as
    ``dreamer_v3.py``'s ``local_step`` and ``imagination_rollout`` split it."""
    key = jax.random.fold_in(key, 0)  # the data-axis index of the single device
    k_wm, k_img = jax.random.split(key)
    posterior = jax.random.gumbel(k_wm, (T, B, S, D))
    k0, key = jax.random.split(k_img)
    k_gum, key = jax.random.split(key)
    prior = jax.random.gumbel(k_gum, (HORIZON, T * B, S, D))
    steps = [k0] + list(jax.random.split(key, HORIZON))
    heads = [[] for _ in ACTIONS]
    for k in steps:
        for j, kh in enumerate(jax.random.split(k, len(ACTIONS))):
            heads[j].append(np.asarray(jax.random.gumbel(kh, (T * B, ACTIONS[j]))))
    return {
        "posterior": torch.from_numpy(np.array(posterior)),
        "prior": torch.from_numpy(np.array(prior)),
        "actions": [torch.from_numpy(np.stack(h)) for h in heads],
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


@pytest.fixture(scope="module")
def jax_side():
    fabric = Fabric(devices=1, accelerator="cpu")
    jcfg = compose(
        overrides=["exp=dreamer_v3_100k_ms_pacman", "env=dummy", "metric.log_level=0"]
        + [f"{k}={v}" for k, v in SMALL.items()]
    )
    space = gym.spaces.Dict({"rgb": gym.spaces.Box(0, 255, (3, 64, 64), np.uint8)})
    wm, actor, critic, params = jax_agent.build_agent(jcfg, ACTIONS, False, space, jax.random.PRNGKey(3))
    # the reward and critic heads start at zero (Hafner): move them, and the target critic off the critic,
    # so that the returns, the advantage and the target term are not zero
    rng = np.random.RandomState(8)
    for tree in (params["world_model"]["reward_model"], params["critic"]):
        tree["head"]["kernel"] = jnp.asarray(0.3 * rng.randn(*tree["head"]["kernel"].shape).astype(np.float32))
    params["target_critic"] = jax.tree_util.tree_map(lambda p: 0.5 * p, params["critic"])
    txs = jax_dv3.build_optimizers_and_state(jcfg, params)
    train_fn = jax_dv3.build_train_fn(wm, actor, critic, *txs[:3], jcfg, fabric, ACTIONS, False)
    return dict(params=jax.device_get(params), state=jax.device_get(txs[3]), train_fn=train_fn)


def _torch_side(params):
    cfg = dreamer_v3_config(**SMALL)
    modules = build_agent(cfg, ACTIONS, False, {"rgb": (3, 64, 64)}, device="cpu", training=True)
    state_dicts, skipped = convert_dreamer_v3(params, training=True)
    assert skipped == []
    for name, module in zip(MODULES, modules):
        module.load_state_dict(state_dicts[name])
    return cfg, build_optimizers_and_state(cfg, *modules)


def _jax_steps(jax_side, batches, keys, taus):
    state = jax.tree_util.tree_map(jnp.array, jax_side["state"])  # the step donates its state
    for batch, key, tau in zip(batches, keys, taus):
        state, metrics = jax_side["train_fn"](state, {k: jnp.asarray(v) for k, v in batch.items()}, key,
                                              jnp.float32(tau))
    return jax.device_get(state), jax.device_get(metrics)


def _check_first_moments(state, new_state):
    """Each optimizer's first moment against optax's: after one step
    ``(1 − β1)·g``, the gradient."""
    for name in ("world_model", "actor", "critic"):
        module, opt = state[name], state["opt"][name]
        moments, _ = convert_dreamer_v3(
            {**new_state["params"], name: _first_moments(new_state["opt"][name])}, training=True
        )
        for pname, p in module.named_parameters():
            want = moments[name][pname].numpy() / 0.1
            np.testing.assert_allclose(
                opt.state[p]["exp_avg"].numpy() / 0.1, want, rtol=GRAD_RTOL,
                atol=GRAD_ATOL_OF_MAX * max(float(np.abs(want).max()), 1.0), err_msg=f"{name}.{pname} gradient",
            )


def _check_params(state, new_state, atol=PARAM_ATOL):
    after, _ = convert_dreamer_v3(new_state["params"], training=True)
    for name in MODULES:
        for pname, value in state[name].state_dict().items():
            np.testing.assert_allclose(
                value.numpy(), after[name][pname].numpy(), rtol=0, atol=atol, err_msg=f"{name}.{pname}"
            )
    for k in ("low", "high"):
        np.testing.assert_allclose(float(state["moments"][k]), float(new_state["moments"][k]), **METRIC_TOL)


def _check_metrics(metrics, j_metrics):
    assert set(metrics) == set(j_metrics)
    for name, value in metrics.items():
        np.testing.assert_allclose(float(value), float(j_metrics[name]), **METRIC_TOL, err_msg=name)


def test_rederived_noise_gives_jax_own_samples():
    """``jax.random.categorical`` samples ``argmax(logits + gumbel(key,
    logits.shape))``: the re-derived noise reproduces the JAX actor's own
    samples."""
    logits = np.random.RandomState(2).randn(T * B, ACTIONS[0]).astype(np.float32)
    dist = jax_agent.build_actor_dists([jnp.asarray(logits)], False, "discrete", unimix=0.01)
    for key in jax.random.split(jax.random.PRNGKey(9), 3):
        want = np.asarray(jax_agent.sample_actor_actions(dist, False, key, True)[0])
        gumbel = np.asarray(jax.random.gumbel(jax.random.split(key, 1)[0], logits.shape))
        np.testing.assert_array_equal((np.asarray(dist[0].logits) + gumbel).argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("tau", [0.02, 1.0])
def test_train_step_matches_jax(jax_side, tau):
    key = jax.random.PRNGKey(11)
    batch = _batch()
    new_state, j_metrics = _jax_steps(jax_side, [batch], [key], [tau])

    cfg, state = _torch_side(jax_side["params"])
    train_step = build_train_fn(cfg, ACTIONS, False)
    metrics = train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, _jax_noise(key), tau=tau)
    _check_metrics(metrics, j_metrics)
    _check_first_moments(state, new_state)
    _check_params(state, new_state)


def test_two_step_burst_matches_jax(jax_side):
    """A burst of two gradient steps (the first hard-copies the target, the
    second moves it by τ) on two batches: the last step's metrics, the
    parameters, the target and the ``Moments`` state after both."""
    keys = list(jax.random.split(jax.random.PRNGKey(12), 2))
    batches = [_batch(31), _batch(32)]
    taus = [1.0, 0.02]
    new_state, j_metrics = _jax_steps(jax_side, batches, keys, taus)

    cfg, state = _torch_side(jax_side["params"])
    program = build_train_fn(cfg, ACTIONS, False)
    stack = {k: torch.from_numpy(np.stack([b[k] for b in batches])) for k in batches[0]}
    metrics = run_train_burst(program, state, stack, taus, noise=[_jax_noise(k) for k in keys])
    assert program.static is not None and program.static.step.eager_calls == 2
    _check_metrics(metrics, j_metrics)
    _check_first_moments(state, new_state)
    _check_params(state, new_state, BURST_PARAM_ATOL)


def test_update_moments_matches_jax():
    rng = np.random.RandomState(4)
    state = {"low": np.float32(-0.3), "high": np.float32(1.7)}
    x = (2.0 * rng.randn(HORIZON, 37, 1)).astype(np.float32)
    want_state, want_offset, want_invscale = jax_update_moments(
        {k: jnp.asarray(v) for k, v in state.items()}, jnp.asarray(x), 0.99, 1.0, 0.05, 0.95
    )
    got_state, offset, invscale = update_moments(
        {k: torch.tensor(v) for k, v in state.items()}, torch.from_numpy(x), 0.99, 1.0, 0.05, 0.95
    )
    for k in ("low", "high"):
        np.testing.assert_allclose(float(got_state[k]), float(want_state[k]), **FN_TOL)
    np.testing.assert_allclose(float(offset), float(want_offset), **FN_TOL)
    np.testing.assert_allclose(float(invscale), float(want_invscale), **FN_TOL)
    fresh = init_moments()
    assert float(fresh["low"]) == 0.0 and float(fresh["high"]) == 0.0
    _, _, floor = update_moments(fresh, torch.zeros(5), 0.99, 1e8, 0.05, 0.95)
    assert float(floor) == pytest.approx(1e-8)


def test_lambda_values_match_jax():
    rng = np.random.RandomState(5)
    r, v = (rng.randn(HORIZON, 6, 1).astype(np.float32) for _ in range(2))
    c = (0.99 * (rng.rand(HORIZON, 6, 1) > 0.2)).astype(np.float32)
    want = np.asarray(jax_lambda_values(*(jnp.asarray(a) for a in (r, v, c)), lmbda=0.95))
    got = compute_lambda_values(*(torch.from_numpy(a) for a in (r, v, c)), lmbda=0.95)
    np.testing.assert_allclose(got.numpy(), want, **FN_TOL)


def test_categorical_kl_matches_jax():
    rng = np.random.RandomState(6)
    p, q = (rng.randn(T, B, S, D).astype(np.float32) for _ in range(2))
    want = np.asarray(jax_categorical_kl(jnp.asarray(p), jnp.asarray(q)))
    got = categorical_kl(torch.from_numpy(p), torch.from_numpy(q))
    assert got.shape == (T, B)
    np.testing.assert_allclose(got.numpy(), want, **FN_TOL)


def test_reconstruction_loss_matches_jax():
    """The pixel MSE, symlog vector, two-hot reward and Bernoulli continue
    heads, the KL balance with element-wise free nats."""
    rng = np.random.RandomState(7)
    recon, obs = rng.randn(T, B, 3, 8, 8).astype(np.float32), rng.rand(T, B, 3, 8, 8).astype(np.float32)
    vec, vec_obs = rng.randn(T, B, 5).astype(np.float32), (4 * rng.randn(T, B, 5)).astype(np.float32)
    reward_logits, rewards = rng.randn(T, B, 255).astype(np.float32), (3 * rng.randn(T, B, 1)).astype(np.float32)
    cont = rng.randn(T, B, 1).astype(np.float32)
    targets = (1.0 - (rng.rand(T, B, 1) < 0.2)).astype(np.float32)
    priors, posts = (rng.randn(T, B, S, D).astype(np.float32) for _ in range(2))
    args = dict(kl_dynamic=0.5, kl_representation=0.1, kl_free_nats=1.0, kl_regularizer=0.7,
                continue_scale_factor=0.5)
    j = jnp.asarray
    want_loss, want = jax_reconstruction_loss(
        {"rgb": JaxMSE(j(recon), dims=3), "state": JaxSymlog(j(vec), dims=1)}, {"rgb": j(obs), "state": j(vec_obs)},
        JaxTwoHot(j(reward_logits), dims=1), j(rewards), j(priors), j(posts),
        pc=jax_continue_distribution(j(cont)), continue_targets=j(targets), **args,
    )
    t = torch.from_numpy
    loss, got = reconstruction_loss(
        {"rgb": MSEDistribution(t(recon), dims=3), "state": SymlogDistribution(t(vec), dims=1)},
        {"rgb": t(obs), "state": t(vec_obs)}, TwoHotEncodingDistribution(t(reward_logits), dims=1), t(rewards),
        t(priors), t(posts), pc=continue_distribution(t(cont)), continue_targets=t(targets), **args,
    )
    np.testing.assert_allclose(float(loss), float(want_loss), **FN_TOL)
    assert set(got) == set(want)
    for name, value in got.items():
        np.testing.assert_allclose(float(value), float(want[name]), **FN_TOL, err_msg=name)

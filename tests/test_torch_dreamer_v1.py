"""The port's DreamerV1 modules against the JAX package on the CPU.

Both sides get the same weights (the JAX ``build_agent`` at a small width,
carried across by ``convert_dreamer_v1``), the same seeded numpy inputs
and the same pre-drawn noise, re-derived from the JAX key where the JAX
function draws it; seeds are never matched across frameworks.

Tolerances (float32 on the CPU; XLA and PyTorch sum in different orders):

- the GRU cell against ``FusedGRUCell(fused="off")``: atol 1e-6;
- single-function results (the stochastic state, the λ-targets, the
  reconstruction loss and its metrics): rtol 1e-5, atol 1e-6;
- the world model over several chained steps (the posterior loop with
  episode boundaries inside the batch, the imagination, the player): rtol
  1e-4, atol 1e-4; sampled categories and discrete actions are equal.
"""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v1 import agent as jax_agent
from sheeprl_tpu.algos.dreamer_v1.loss import gaussian_independent as jax_gaussian
from sheeprl_tpu.algos.dreamer_v1.loss import reconstruction_loss as jax_reconstruction_loss
from sheeprl_tpu.algos.dreamer_v1.utils import compute_lambda_values as jax_lambda_values
from sheeprl_tpu.algos.dreamer_v1.utils import normalize_obs_jnp
from sheeprl_tpu.config import compose
from sheeprl_tpu.distributions import Bernoulli as JaxBernoulli
from sheeprl_tpu.distributions import Independent as JaxIndependent
from sheeprl_tpu.distributions import Normal as JaxNormal
from sheeprl_tpu.distributions import OneHotCategorical as JaxOneHot
from sheeprl_tpu.models import FusedGRUCell
from sheeprl_tpu_torch.algos.dreamer_v1.agent import build_agent, build_player_fns, compute_stochastic_state
from sheeprl_tpu_torch.algos.dreamer_v1.loss import gaussian_independent, reconstruction_loss
from sheeprl_tpu_torch.algos.dreamer_v1.utils import compute_lambda_values, normalize_obs
from sheeprl_tpu_torch.configs import dreamer_v2_config
from sheeprl_tpu_torch.convert import convert_dreamer_v1
from sheeprl_tpu_torch.distributions import Bernoulli, Independent
from sheeprl_tpu_torch.models import GRUCell

SMALL = {
    "algo.dense_units": 16,
    "algo.mlp_layers": 2,
    "algo.world_model.encoder.cnn_channels_multiplier": 2,
    "algo.world_model.recurrent_model.recurrent_state_size": 12,
    "algo.world_model.stochastic_size": 5,
    "algo.world_model.transition_model.hidden_size": 10,
    "algo.world_model.representation_model.hidden_size": 11,
    "algo.world_model.use_continues": True,
}
S, H_REC, B, T = 5, 12, 3, 5
OBS = {"rgb": (3, 64, 64), "state": (4,)}
KEYS = {"cnn_keys.encoder": ["rgb"], "cnn_keys.decoder": ["rgb"], "mlp_keys.encoder": ["state"],
        "mlp_keys.decoder": ["state"]}
GRU_TOL = dict(rtol=0, atol=1e-6)
FN_TOL = dict(rtol=1e-5, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-4)


def _jax_space(obs=OBS):
    return gym.spaces.Dict({
        k: gym.spaces.Box(0, 255, shape, np.uint8) if len(shape) == 3 else gym.spaces.Box(-1, 1, shape, np.float32)
        for k, shape in obs.items()
    })


def _build(actions, continuous, seed=3):
    overrides = {**SMALL, **KEYS}
    jcfg = compose(overrides=["exp=dreamer_v1"] + [f"{k}={v}" for k, v in overrides.items()])
    wm, actor, critic, params = jax_agent.build_agent(jcfg, actions, continuous, _jax_space(), jax.random.PRNGKey(seed))
    params = jax.device_get(params)
    state_dicts, skipped = convert_dreamer_v1(params, training=True)
    assert skipped == []
    tcfg = dreamer_v2_config("dreamer_v1", **overrides)
    twm, tactor, tcritic = build_agent(tcfg, actions, continuous, OBS, device="cpu", training=True)
    for name, module in (("world_model", twm), ("actor", tactor), ("critic", tcritic)):
        module.load_state_dict(state_dicts[name])
    return dict(jcfg=jcfg, wm=wm, actor=actor, critic=critic, params=params, tcfg=tcfg, twm=twm, tactor=tactor)


@pytest.fixture(scope="module")
def agents():
    return _build((4,), False)


@pytest.fixture(scope="module")
def continuous_agents():
    return _build((2,), True)


def _frames(rng, lead):
    return {"rgb": rng.randint(0, 256, lead + OBS["rgb"]).astype(np.uint8),
            "state": rng.uniform(-1, 1, lead + OBS["state"]).astype(np.float32)}


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("batch", [1, 7])
def test_gru_cell_matches_the_flax_cell(batch):
    X, H = 6, 9
    rng = np.random.RandomState(batch)
    x, h = rng.randn(batch, X).astype(np.float32), rng.randn(batch, H).astype(np.float32)
    cell = FusedGRUCell(H, fused="off")
    params = jax.device_get(cell.init(jax.random.PRNGKey(batch), jnp.asarray(h), jnp.asarray(x))["params"])
    # random biases: flax initializes them to zero
    params = {k: {n: v + (rng.randn(*v.shape).astype(np.float32) if n == "bias" else 0) for n, v in p.items()}
              for k, p in params.items()}
    want = np.asarray(cell.apply({"params": params}, jnp.asarray(h), jnp.asarray(x))[0])
    mine = GRUCell(X, H)
    mine.load_state_dict({f"{k}.{'weight' if n == 'kernel' else n}": _t(v.T if n == "kernel" else v)
                          for k, p in params.items() for n, v in p.items()})
    assert sorted(mine.state_dict()) == sorted(
        f"{k}.{'weight' if n == 'kernel' else n}" for k, p in params.items() for n in p
    )
    np.testing.assert_allclose(mine(_t(x), _t(h)).detach().numpy(), want, **GRU_TOL)


def test_compute_stochastic_state_matches_jax():
    rng = np.random.RandomState(2)
    info, noise = rng.randn(B, 2 * S).astype(np.float32), rng.randn(B, S).astype(np.float32)
    (jm, js), jstate = jax_agent.compute_stochastic_state(jnp.asarray(info), None, 0.1, noise=jnp.asarray(noise))
    (m, s), state = compute_stochastic_state(_t(info), 0.1, noise=_t(noise))
    for got, want in ((m, jm), (s, js), (state, jstate)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FN_TOL)


def _wm_apply(a, method, *args):
    return a["wm"].apply({"params": a["params"]["world_model"]}, *args, method=method)


def test_posterior_loop_over_episode_boundaries_matches_jax(agents):
    """T posterior steps from zero states with the actions as stored and no
    reset at the episode boundaries inside the batch (a done at t=1 in row 2,
    the next row an episode's first), then the prior's statistics batched
    over ``[T, B]``: the JAX loss's scan, step by step."""
    a = agents
    rng = np.random.RandomState(4)
    frames = _frames(rng, (T, B))
    actions = np.eye(4, dtype=np.float32)[rng.randint(0, 4, (T, B))]
    actions[2, 2] = 0.0  # the reset row after the done: a zero action, as the loop stores it
    noise = rng.randn(T, B, S).astype(np.float32)
    jembed = _wm_apply(a, jax_agent.WorldModel.encode, normalize_obs_jnp(frames, ["rgb"]))
    embed = a["twm"].encode(normalize_obs(frames, ["rgb"], torch.device("cpu")))
    np.testing.assert_allclose(embed.detach().numpy(), np.asarray(jembed), **TOL)
    jpost, jrec = jnp.zeros((B, S)), jnp.zeros((B, H_REC))
    post, rec = torch.zeros(B, S), torch.zeros(B, H_REC)
    recs = []
    for t in range(T):
        jrec, jpost, (jm, js) = _wm_apply(a, jax_agent.WorldModel.dynamic_posterior, jpost, jrec,
                                          jnp.asarray(actions[t]), jembed[t], None, jnp.asarray(noise[t]))
        rec, post, (m, s) = a["twm"].rssm.dynamic_posterior(post, rec, _t(actions[t]), embed[t], noise=_t(noise[t]))
        for got, want in ((rec, jrec), (post, jpost), (m, jm), (s, js)):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
        recs.append(rec)
    jprior = _wm_apply(a, jax_agent.WorldModel.prior_stats, jnp.stack([jnp.asarray(r.detach().numpy()) for r in recs]))
    prior = a["twm"].rssm.prior_stats(torch.stack(recs))
    for got, want in zip(prior, jprior):
        assert got.shape == (T, B, S)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_imagination_matches_jax(agents):
    a = agents
    rng = np.random.RandomState(5)
    jprior, jrec = jnp.asarray(rng.randn(6, S).astype(np.float32)), jnp.asarray(rng.randn(6, H_REC).astype(np.float32))
    prior, rec = _t(np.asarray(jprior)), _t(np.asarray(jrec))
    for _ in range(3):
        act = np.eye(4, dtype=np.float32)[rng.randint(0, 4, 6)]
        noise = rng.randn(6, S).astype(np.float32)
        jprior, jrec = _wm_apply(a, jax_agent.WorldModel.imagination, jprior, jrec, jnp.asarray(act), None,
                                 jnp.asarray(noise))
        prior, rec = a["twm"].rssm.imagination(prior, rec, _t(act), noise=_t(noise))
        np.testing.assert_allclose(prior.detach().numpy(), np.asarray(jprior), **TOL)
        np.testing.assert_allclose(rec.detach().numpy(), np.asarray(jrec), **TOL)


def _reference_lambda(rewards, values, continues, last_values, lmbda):
    """The V1 recursion as ``tests/test_algos/test_dreamer_v1.py`` writes it."""
    H = rewards.shape[0]
    last_lambda, lv = np.zeros_like(values[0]), []
    for step in reversed(range(H - 1)):
        next_values = last_values if step == H - 2 else values[step + 1] * (1 - lmbda)
        last_lambda = rewards[step] + next_values * continues[step] + lmbda * continues[step] * last_lambda
        lv.append(last_lambda)
    return np.stack(lv[::-1])


@pytest.mark.parametrize("horizon", [2, 7])
def test_lambda_values_match_jax_and_the_reference_recursion(horizon):
    rng = np.random.RandomState(horizon)
    r, v = (rng.randn(horizon, 6, 1).astype(np.float32) for _ in range(2))
    c = rng.uniform(0.5, 1.0, (horizon, 6, 1)).astype(np.float32)
    want = np.asarray(jax_lambda_values(jnp.asarray(r), jnp.asarray(v), jnp.asarray(c), jnp.asarray(v[-1]), 0.95))
    got = compute_lambda_values(_t(r), _t(v), _t(c), _t(v[-1]), 0.95).numpy()
    assert got.shape == (horizon - 1, 6, 1)
    np.testing.assert_allclose(got, want, **FN_TOL)
    np.testing.assert_allclose(got, _reference_lambda(r, v, c, v[-1], 0.95), **FN_TOL)


@pytest.mark.parametrize("use_continues", [False, True])
@pytest.mark.parametrize("free_nats", [0.0, 3.0])
def test_reconstruction_loss_matches_jax(use_continues, free_nats):
    """Unit Gaussians over an image's 3 dimensions and a vector's 1, the
    state loss ``max(free_nats, mean KL)``; the continue loss on ``1 − done``
    only with ``use_continues``."""
    rng = np.random.RandomState(6)
    recon, obs = (rng.randn(T, B, 3, 8, 8).astype(np.float32) for _ in range(2))
    vrec, vobs = (rng.randn(T, B, 4).astype(np.float32) for _ in range(2))
    reward_mean, rewards, cont = (rng.randn(T, B, 1).astype(np.float32) for _ in range(3))
    pm, qm = (rng.randn(T, B, S).astype(np.float32) for _ in range(2))
    ps, qs = (rng.uniform(0.1, 2.0, (T, B, S)).astype(np.float32) for _ in range(2))
    targets = 1.0 - (rng.rand(T, B, 1) < 0.2).astype(np.float32)
    args = dict(kl_free_nats=free_nats, kl_regularizer=0.7, continue_scale_factor=0.5)
    j = jnp.asarray
    want_loss, want = jax_reconstruction_loss(
        {"rgb": jax_gaussian(j(recon), 1.0, 3), "state": jax_gaussian(j(vrec), 1.0, 1)},
        {"rgb": j(obs), "state": j(vobs)}, jax_gaussian(j(reward_mean), 1.0, 1), j(rewards),
        JaxIndependent(JaxNormal(j(pm), j(ps)), 1), JaxIndependent(JaxNormal(j(qm), j(qs)), 1),
        qc=JaxIndependent(JaxBernoulli(logits=j(cont)), 1) if use_continues else None,
        continue_targets=j(targets) if use_continues else None, **args,
    )
    loss, got = reconstruction_loss(
        {"rgb": gaussian_independent(_t(recon), 1.0, 3), "state": gaussian_independent(_t(vrec), 1.0, 1)},
        {"rgb": _t(obs), "state": _t(vobs)}, gaussian_independent(_t(reward_mean), 1.0, 1), _t(rewards),
        gaussian_independent(_t(pm), _t(ps), 1), gaussian_independent(_t(qm), _t(qs), 1),
        qc=Independent(Bernoulli(logits=_t(cont)), 1) if use_continues else None,
        continue_targets=_t(targets) if use_continues else None, **args,
    )
    np.testing.assert_allclose(float(loss), float(want_loss), **FN_TOL)
    assert set(got) == set(want)
    for name, value in got.items():
        np.testing.assert_allclose(float(value), float(want[name]), **FN_TOL, err_msg=name)
    assert (float(got["Loss/continue_loss"]) != 0.0) == use_continues


def _jax_player_noise(key, n, continuous, greedy, actions_dim):
    """The JAX player's draws from ``key``, as ``build_player_fns`` splits it:
    the posterior's standard normals and the actions' sampling noise
    (greedy discrete: none; greedy continuous: the best-of-100 uniforms)."""
    k_repr, k_act = jax.random.split(key)
    posterior = np.array(jax.random.normal(k_repr, (n, S)))
    head_keys = jax.random.split(k_act, len(actions_dim) if not continuous else 1)
    if continuous:
        shape = ((100,) if greedy else ()) + (n, int(sum(actions_dim)))
        heads = [np.array(jax.random.uniform(head_keys[0], shape, minval=1e-6, maxval=1 - 1e-6))]
    else:
        heads = [np.array(jax.random.gumbel(k, (n, d))) for k, d in zip(head_keys, actions_dim)]
    return posterior, heads


@pytest.mark.parametrize("continuous", [False, True])
@pytest.mark.parametrize("mode", ["greedy", "explore"])
def test_player_matches_jax(agents, continuous_agents, continuous, mode):
    """Three chained steps of the JAX player (``build_player_fns``) and the
    port's at the same weights, frames and noise, one row reset at the
    second step: greedy, or the exploration action at ``expl_amount`` 0.4
    (discrete: a uniform category where ``u < 0.4``; continuous: Gaussian
    noise clipped to [-1, 1])."""
    a = continuous_agents if continuous else agents
    actions_dim = (2,) if continuous else (4,)
    jfns = jax_agent.build_player_fns(a["wm"], a["actor"], a["jcfg"], actions_dim, continuous)
    fns = build_player_fns(a["twm"], a["tactor"], a["tcfg"], actions_dim, continuous)
    wm_p, actor_p = a["params"]["world_model"], a["params"]["actor"]
    rng = np.random.RandomState(8)
    jstate, tstate = jfns["init_states"](wm_p, B), fns["init_states"](B)
    for step in range(3):
        if step == 1:
            mask = np.array([[0.0], [1.0], [0.0]], np.float32)
            jstate = jfns["reset_states"](wm_p, jstate, jnp.asarray(mask))
            tstate = fns["reset_states"](tstate, _t(mask))
        frames = _frames(rng, (B,))
        key = jax.random.PRNGKey(20 + step)
        jobs = normalize_obs_jnp(frames, ["rgb"])
        obs = normalize_obs(frames, ["rgb"], torch.device("cpu"))
        if mode == "greedy":
            jact, jstate = jfns["greedy_action"](wm_p, actor_p, jstate, jobs, key)
            posterior, heads = _jax_player_noise(key, B, continuous, True, actions_dim)
            act, tstate = fns["greedy_action"](tstate, obs, gumbel=_t(posterior),
                                               action_noise=[_t(h) for h in heads] if continuous else None)
        else:
            jact, jstate = jfns["exploration_action"](wm_p, actor_p, jstate, jobs, key, jnp.float32(0.4))
            k_step, k_expl = jax.random.split(key)
            posterior, heads = _jax_player_noise(k_step, B, continuous, False, actions_dim)
            if continuous:
                expl = [_t(np.array(jax.random.normal(k_expl, (B, actions_dim[0]))))]
            else:
                k_cat, k_u = jax.random.split(k_expl, 2)
                category = np.asarray(JaxOneHot(logits=jnp.zeros((B, actions_dim[0]))).sample(k_cat)).argmax(-1)
                expl = [(_t(category), _t(np.array(jax.random.uniform(k_u, (B, 1)))))]
            act, tstate = fns["exploration_action"](tstate, obs, 0.4, gumbel=_t(posterior),
                                                    action_gumbels=[_t(h) for h in heads], expl_noise=expl)
        for k in ("recurrent", "stochastic", "actions"):
            np.testing.assert_allclose(tstate[k].numpy(), np.asarray(jstate[k]), **TOL, err_msg=f"{mode} {k}")
        if continuous:
            np.testing.assert_allclose(act[0].numpy(), np.asarray(jact[0]), **TOL)
        else:
            np.testing.assert_array_equal(act[0].numpy().argmax(-1), np.asarray(jact[0]).argmax(-1))


def test_converter_consumes_every_leaf_of_a_full_width_tree():
    """A full ``exp=dreamer_v1`` tree (with the continue head and a vector
    key): every leaf is converted and loads strictly into a full-width
    training build; a serving conversion lists the training-only leaves as
    skipped; an unknown leaf and a target critic raise. The tree's shapes
    come from ``jax.eval_shape`` of the JAX ``build_agent``."""
    overrides = {**KEYS, "algo.world_model.use_continues": True}
    jcfg = compose(overrides=["exp=dreamer_v1"] + [f"{k}={v}" for k, v in overrides.items()])
    shapes = jax.eval_shape(lambda k: jax_agent.build_agent(jcfg, (4,), False, _jax_space(), k)[3],
                            jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map(lambda s: rng.randn(*s.shape).astype(s.dtype), shapes)
    state_dicts, skipped = convert_dreamer_v1(params, training=True)
    assert skipped == [] and sorted(state_dicts) == ["actor", "critic", "world_model"]
    modules = build_agent(dreamer_v2_config("dreamer_v1", **overrides), (4,), False, OBS, device="cpu", training=True)
    assert modules[0].rssm.recurrent_model.gru.hidden_size == 200 and modules[0].rssm.min_std == 0.1
    for name, module in zip(("world_model", "actor", "critic"), modules):
        assert len(state_dicts[name]) == len(jax.tree_util.tree_leaves(params[name])), name
        module.load_state_dict(state_dicts[name])
        assert sum(p.numel() for p in module.state_dict().values()) == sum(
            np.asarray(x).size for x in jax.tree_util.tree_leaves(params[name])
        )
    serving, skipped = convert_dreamer_v1(params)
    assert sorted(serving) == ["actor", "world_model"]
    assert any(p.startswith("world_model/cnn_decoder/") for p in skipped)
    assert any(p.startswith("critic/") for p in skipped)
    build_agent(dreamer_v2_config("dreamer_v1", **overrides), (4,), False, OBS, device="cpu")[0].load_state_dict(
        serving["world_model"]
    )
    with pytest.raises(KeyError, match="target_critic"):
        convert_dreamer_v1({**params, "target_critic": params["critic"]}, training=True)
    params["world_model"]["rssm"]["recurrent_model"]["gru"]["mystery"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="mystery"):
        convert_dreamer_v1(params, training=True)

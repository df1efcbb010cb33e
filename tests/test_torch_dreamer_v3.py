"""The port's DreamerV3 modules against the JAX package on the CPU.

Distributions on the same numbers; the models and the player at a small
width with the JAX ``build_agent``'s weights carried across by
``convert_dreamer_v3`` and the same pre-drawn noise on both sides (seeds are
never matched across the frameworks); the Hafner initialization on
statistics (the PRNG streams differ).

Tolerances (float32 on the CPU, XLA and PyTorch sum in different orders):

- the two-hot target: exactly the JAX target (the same index arithmetic);
  log-probabilities and the other heads: rtol 1e-5, atol 1e-6; the two-hot
  mean rtol 1e-5, atol 1e-5 (a sum over 255 bins of magnitude up to 20, in
  another order: about 1e-6 of float32 rounding near a mean of 0);
- model outputs, player states and the cell's output: rtol 1e-4, atol 1e-4
  (convolutions over chained steps); sampled categories and actions equal;
  the cell's gradients against the Pallas ``custom_vjp``: rtol 1e-4, atol
  1e-5;
- initialization: each weight's standard deviation within 3% of the JAX
  leaf's (at least 10,000 elements a leaf is compared), uniform heads
  within their limit, zeros exact.
"""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_jit_build import jit_build

from sheeprl_tpu.algos.dreamer_v3 import agent as jax_agent
from sheeprl_tpu.algos.dreamer_v3.utils import normalize_obs_jnp
from sheeprl_tpu.config import compose
from sheeprl_tpu.distributions import Bernoulli as JaxBernoulli
from sheeprl_tpu.distributions import MSEDistribution as JaxMSE
from sheeprl_tpu.distributions import SymlogDistribution as JaxSymlog
from sheeprl_tpu.distributions import TwoHotEncodingDistribution as JaxTwoHot
from sheeprl_tpu.distributions.distributions import symexp as jax_symexp
from sheeprl_tpu.distributions.distributions import symlog as jax_symlog
from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent, build_player_fns
from sheeprl_tpu_torch.algos.dreamer_v3.utils import normalize_obs
from sheeprl_tpu_torch.configs import dreamer_v3_config
from sheeprl_tpu_torch.convert import convert_dreamer_v3
from sheeprl_tpu_torch.distributions import (
    Bernoulli,
    MSEDistribution,
    SymlogDistribution,
    TwoHotEncodingDistribution,
    symexp,
    symlog,
)

SMALL = {
    "algo.dense_units": 16,
    "algo.mlp_layers": 2,
    "algo.world_model.encoder.cnn_channels_multiplier": 4,
    "algo.world_model.recurrent_model.recurrent_state_size": 24,
    "algo.world_model.stochastic_size": 4,
    "algo.world_model.discrete_size": 5,
    "algo.world_model.transition_model.hidden_size": 20,
    "algo.world_model.representation_model.hidden_size": 20,
    "cnn_keys.encoder": ["rgb"],
    "mlp_keys.encoder": ["state"],
    "cnn_keys.decoder": ["rgb"],
    "mlp_keys.decoder": ["state"],
}
ACTIONS = (9,)
B = 3
S, D, H = 4, 5, 24
FN_TOL = dict(rtol=1e-5, atol=1e-6)
MEAN_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
OBS = {"rgb": (3, 64, 64), "state": (7,)}


def _jax_space():
    return gym.spaces.Dict({
        "rgb": gym.spaces.Box(0, 255, (3, 64, 64), np.uint8),
        "state": gym.spaces.Box(-10, 10, (7,), np.float32),
    })


def _jax_cfg(overrides, exp="dreamer_v3_100k_ms_pacman"):
    return compose(overrides=[f"exp={exp}", "env=dummy"] + [f"{k}={v}" for k, v in overrides.items()])


@pytest.fixture(scope="module")
def agents():
    jcfg = _jax_cfg(SMALL)
    wm, actor, critic, params = jit_build(jax_agent.build_agent, jcfg, ACTIONS, False, _jax_space(), jax.random.PRNGKey(3))
    params = jax.device_get(params)
    state_dicts, skipped = convert_dreamer_v3(params, training=True)
    assert skipped == []
    tcfg = dreamer_v3_config(**SMALL)
    twm, tactor, tcritic, ttarget = build_agent(tcfg, ACTIONS, False, OBS, device="cpu", training=True)
    for name, module in (("world_model", twm), ("actor", tactor), ("critic", tcritic), ("target_critic", ttarget)):
        module.load_state_dict(state_dicts[name])
        module.eval()
    return dict(jcfg=jcfg, wm=wm, actor=actor, critic=critic, params=params, tcfg=tcfg, twm=twm, tactor=tactor,
                tcritic=tcritic)


def _frames(rng, n=B):
    return {
        "rgb": rng.randint(0, 256, (n, 3, 64, 64)).astype(np.uint8),
        "state": (3.0 * rng.randn(n, 7)).astype(np.float32),
    }


# ---------------------------------------------------------------------------
# distributions
# ---------------------------------------------------------------------------


def test_symlog_and_symexp_match_jax():
    x = np.array([0.0, -0.0, 1e-7, -1e-3, 0.5, -2.0, 30.0, -1e4, 1e8], np.float32)
    np.testing.assert_allclose(symlog(torch.from_numpy(x)).numpy(), np.asarray(jax_symlog(jnp.asarray(x))), **FN_TOL)
    np.testing.assert_allclose(symexp(torch.from_numpy(x[:7])).numpy(), np.asarray(jax_symexp(jnp.asarray(x[:7]))),
                               **FN_TOL)


def _two_hot_points():
    """Symlog-space points: every bin exactly, the ±20 edges, points past
    them, and points between bins."""
    bins = np.asarray(jnp.linspace(-20.0, 20.0, 255, dtype=jnp.float32))
    between = (bins[:-1] + bins[1:]) / 2
    rng = np.random.RandomState(0)
    return np.concatenate([bins, [-20.0, 20.0, -20.5, 20.5, -1e6, 1e6], between,
                           rng.uniform(-21, 21, 64)]).astype(np.float32)


def test_two_hot_target_is_the_jax_target_at_and_between_bins_and_at_the_edges():
    x = _two_hot_points()
    logits = np.zeros((x.size, 255), np.float32)
    want = np.asarray(JaxTwoHot(jnp.asarray(logits))._two_hot(jnp.asarray(x)))
    got = TwoHotEncodingDistribution(torch.from_numpy(logits)).two_hot(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)
    on_bin = got[:255]  # a value on bin k >= 1 puts all its weight on k (as the upper bin); -20 on bin 0
    np.testing.assert_array_equal(on_bin.argmax(-1), np.arange(255))


@pytest.mark.parametrize("dims", [0, 1, 2])
def test_two_hot_log_prob_and_mean_match_jax(dims):
    rng = np.random.RandomState(1)
    n = _two_hot_points().size
    logits = rng.randn(n, 2, 255).astype(np.float32)
    # values whose symlog falls on, between and past the bins
    values = np.asarray(jax_symexp(jnp.asarray(_two_hot_points())))[:, None, None].repeat(2, 1)
    values = np.clip(values, -1e8, 1e8).astype(np.float32)
    j = JaxTwoHot(jnp.asarray(logits), dims=dims)
    t = TwoHotEncodingDistribution(torch.from_numpy(logits), dims=dims)
    np.testing.assert_allclose(t.log_prob(torch.from_numpy(values)).numpy(),
                               np.asarray(j.log_prob(jnp.asarray(values))), **FN_TOL)
    np.testing.assert_allclose(t.mean.numpy(), np.asarray(j.mean), **MEAN_TOL)
    np.testing.assert_allclose(t.mode.numpy(), np.asarray(j.mode), **MEAN_TOL)


@pytest.mark.parametrize("dist,agg", [("mse", "sum"), ("abs", "mean")])
def test_symlog_and_mse_heads_match_jax(dist, agg):
    rng = np.random.RandomState(2)
    pred, target = rng.randn(4, 3, 7).astype(np.float32), (5 * rng.randn(4, 3, 7)).astype(np.float32)
    j = JaxSymlog(jnp.asarray(pred), dims=1, dist=dist, agg=agg)
    t = SymlogDistribution(torch.from_numpy(pred), dims=1, dist=dist, agg=agg)
    np.testing.assert_allclose(t.log_prob(torch.from_numpy(target)).numpy(),
                               np.asarray(j.log_prob(jnp.asarray(target))), **FN_TOL)
    np.testing.assert_allclose(t.mode.numpy(), np.asarray(j.mode), **FN_TOL)
    img, obs = rng.randn(2, 3, 3, 8, 8).astype(np.float32), rng.rand(2, 3, 3, 8, 8).astype(np.float32)
    np.testing.assert_allclose(MSEDistribution(torch.from_numpy(img), dims=3, agg=agg).log_prob(torch.from_numpy(obs)),
                               np.asarray(JaxMSE(jnp.asarray(img), dims=3, agg=agg).log_prob(jnp.asarray(obs))),
                               **FN_TOL)


def test_bernoulli_mode_matches_jax():
    logits = np.array([-2.0, -0.0, 0.0, 1e-7, 3.0], np.float32)
    np.testing.assert_array_equal(Bernoulli(torch.from_numpy(logits)).mode.numpy(),
                                  np.asarray(JaxBernoulli(jnp.asarray(logits)).mode))


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------


def _wm(a, method, *args):
    return a["wm"].apply({"params": a["params"]["world_model"]}, *args, method=method)


def test_world_model_heads_match_jax(agents):
    a = agents
    rng = np.random.RandomState(3)
    frames = _frames(rng, 2 * B)
    latent = rng.randn(2, B, S * D + H).astype(np.float32)
    rec = rng.randn(2, B, H).astype(np.float32)
    jw = jax_agent.WorldModel
    with torch.no_grad():
        embed = a["twm"].encode(normalize_obs(frames, ["rgb"], torch.device("cpu")))
        np.testing.assert_allclose(embed.numpy(), np.asarray(_wm(a, jw.encode, normalize_obs_jnp(frames, ["rgb"]))),
                                   **TOL)
        proj = a["twm"].rssm.project_embed(embed)
        np.testing.assert_allclose(proj.numpy(), np.asarray(_wm(a, jw.project_embed, jnp.asarray(embed.numpy()))),
                                   **TOL)
        t_latent = torch.from_numpy(latent)
        recon = a["twm"].decode(t_latent)
        j_recon = _wm(a, jw.decode, jnp.asarray(latent))
        for k in ("rgb", "state"):
            np.testing.assert_allclose(recon[k].numpy(), np.asarray(j_recon[k]), **TOL, err_msg=k)
        for mine, theirs in (("reward_logits", jw.reward_logits), ("continue_logits", jw.continue_logits)):
            np.testing.assert_allclose(getattr(a["twm"], mine)(t_latent).numpy(),
                                       np.asarray(_wm(a, theirs, jnp.asarray(latent))), **TOL, err_msg=mine)
        np.testing.assert_allclose(a["twm"].rssm.prior_logits(torch.from_numpy(rec)).numpy(),
                                   np.asarray(_wm(a, jw.prior_logits, jnp.asarray(rec))), **TOL)
        zero = np.zeros((1, H), np.float32)
        np.testing.assert_allclose(a["twm"].initial_posterior(torch.from_numpy(zero)).numpy(),
                                   np.asarray(_wm(a, jw.initial_posterior, jnp.asarray(zero))), **TOL)
        np.testing.assert_allclose(
            a["tcritic"](t_latent).numpy(),
            np.asarray(a["critic"].apply({"params": a["params"]["critic"]}, jnp.asarray(latent))), **TOL,
        )
        np.testing.assert_allclose(
            a["tactor"](t_latent)[0].numpy(),
            np.asarray(a["actor"].apply({"params": a["params"]["actor"]}, jnp.asarray(latent))[0]), **TOL,
        )


def test_posterior_step_matches_jax(agents):
    """``dynamic_posterior`` over three chained steps with an ``is_first``
    row: the recurrent state, the posterior (straight-through values at the
    same Gumbel noise) and its logits."""
    a = agents
    rng = np.random.RandomState(4)
    jw = jax_agent.WorldModel
    zero = np.zeros((1, H), np.float32)
    with torch.no_grad():
        init_post = a["twm"].initial_posterior(torch.from_numpy(zero))
    j_init = _wm(a, jw.initial_posterior, jnp.asarray(zero))
    post, rec = np.zeros((B, S * D), np.float32), np.zeros((B, H), np.float32)
    t_post, t_rec = torch.from_numpy(post), torch.from_numpy(rec)
    j_post, j_rec = jnp.asarray(post), jnp.asarray(rec)
    for t in range(3):
        action = np.eye(ACTIONS[0], dtype=np.float32)[rng.randint(0, ACTIONS[0], B)]
        eproj = rng.randn(B, 20).astype(np.float32)
        first = np.array([[1.0], [0.0], [float(t == 1)]], np.float32)
        gumbel = rng.gumbel(size=(B, S, D)).astype(np.float32)
        with torch.no_grad():
            t_rec, t_post, t_logits = a["twm"].rssm.dynamic_posterior(
                t_post, t_rec, torch.from_numpy(action), torch.from_numpy(eproj), torch.from_numpy(first), init_post,
                gumbel=torch.from_numpy(gumbel),
            )
        j_rec, j_post, j_logits = _wm(
            a, jw.dynamic_posterior, j_post, j_rec, jnp.asarray(action), jnp.asarray(eproj), jnp.asarray(first),
            j_init, None, jnp.asarray(gumbel),
        )
        np.testing.assert_allclose(t_rec.numpy(), np.asarray(j_rec), **TOL)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **TOL)
        np.testing.assert_allclose(t_post.numpy(), np.asarray(j_post), **TOL)


def _jax_player_step(a, state, obs, gumbel, action_gumbel, greedy):
    """The JAX player's ``_step`` composed from its methods, at injected noise."""
    jw = jax_agent.WorldModel
    embed = _wm(a, jw.encode, obs)
    rec = _wm(a, jw.recurrent_step, state["stochastic"], state["actions"], state["recurrent"])
    _, post = a["wm"].apply(
        {"params": a["params"]["world_model"]}, rec, embed, jnp.asarray(gumbel),
        method=lambda m, r, e, g: m.rssm._representation_projected(r, m.rssm.project_embed(e), None, gumbel=g),
    )
    pre = a["actor"].apply({"params": a["params"]["actor"]}, jnp.concatenate([post, rec], -1))
    dist = jax_agent.build_actor_dists(pre, False, "discrete", unimix=0.01)[0]
    if greedy:
        action = np.asarray(dist.mode)
    else:
        action = np.eye(ACTIONS[0], dtype=np.float32)[(np.asarray(dist.logits) + action_gumbel).argmax(-1)]
    return {"actions": jnp.asarray(action), "recurrent": rec, "stochastic": post}


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_player_matches_jax_composition(agents, greedy):
    """Three chained player steps at injected noise, one row reset at the
    second (``mask·fresh + (1−mask)·state``, the fresh stochastic state the
    prior's mode at a zero recurrent state)."""
    a = agents
    fns = build_player_fns(a["twm"], a["tactor"], a["tcfg"], ACTIONS, False)
    rng = np.random.RandomState(5)
    tstate = fns["init_states"](B)
    j_init = _wm(a, jax_agent.WorldModel.initial_posterior, jnp.zeros((B, H)))
    np.testing.assert_allclose(tstate["stochastic"].numpy(), np.asarray(j_init), **TOL)
    jstate = {k: jnp.asarray(v.numpy()) for k, v in tstate.items()}
    fresh = {k: v.numpy() for k, v in fns["init_states"](B).items()}
    for t in range(3):
        if t == 1:
            mask = np.array([[0.0], [1.0], [0.0]], np.float32)
            tstate = fns["reset_states"](tstate, torch.from_numpy(mask))
            jstate = {k: mask * fresh[k] + (1.0 - mask) * np.asarray(v) for k, v in jstate.items()}
        frames = _frames(rng)
        gumbel = rng.gumbel(size=(B, S, D)).astype(np.float32)
        action_gumbel = rng.gumbel(size=(B, ACTIONS[0])).astype(np.float32)
        jstate = _jax_player_step(a, jstate, normalize_obs_jnp(frames, ["rgb"]), gumbel, action_gumbel, greedy)
        obs = normalize_obs(frames, ["rgb"], torch.device("cpu"))
        if greedy:
            actions, tstate = fns["greedy_action"](tstate, obs, gumbel=torch.from_numpy(gumbel))
        else:
            actions, tstate = fns["exploration_action"](
                tstate, obs, 0.0, gumbel=torch.from_numpy(gumbel), action_gumbels=[torch.from_numpy(action_gumbel)],
                expl_noise=[(torch.zeros(B, dtype=torch.long), torch.ones(B, 1))],
            )
        np.testing.assert_allclose(tstate["recurrent"].numpy(), np.asarray(jstate["recurrent"]), **TOL)
        np.testing.assert_allclose(tstate["stochastic"].numpy(), np.asarray(jstate["stochastic"]), **TOL)
        np.testing.assert_array_equal(actions[0].argmax(-1).numpy(), np.asarray(jstate["actions"]).argmax(-1))


# ---------------------------------------------------------------------------
# converter and initialization
# ---------------------------------------------------------------------------


def test_converter_skips_training_parts_and_raises_on_unknown_leaves(agents):
    params = jax.tree_util.tree_map(lambda x: x, agents["params"])
    state_dicts, skipped = convert_dreamer_v3(params)
    assert sorted(state_dicts) == ["actor", "world_model"]
    for prefix in ("cnn_decoder/", "mlp_decoder/", "reward_model/", "continue_model/"):
        assert any(p.startswith(f"world_model/{prefix}") for p in skipped), prefix
    assert any(p.startswith("critic/") for p in skipped) and any(p.startswith("target_critic/") for p in skipped)
    assert not any("rssm" in p or "encoder" in p or p.startswith("actor/") for p in skipped)
    wm, actor = build_agent(agents["tcfg"], ACTIONS, False, OBS, device="cpu")
    wm.load_state_dict(state_dicts["world_model"])
    actor.load_state_dict(state_dicts["actor"])
    params["world_model"]["rssm"]["mystery"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="mystery"):
        convert_dreamer_v3(params)
    with pytest.raises(KeyError, match="unknown param tree"):
        convert_dreamer_v3({**agents["params"], "moments": {}})


def test_converter_reads_the_earlier_representation_layout(agents):
    """A checkpoint from before the posterior trunk was split holds
    ``representation_model/MLP_0`` (the JAX ``migrate_dv3_checkpoint``
    renames it); it converts to the same weights."""
    params = jax.tree_util.tree_map(lambda x: x, agents["params"])
    rep = params["world_model"]["rssm"]["representation_model"]
    legacy = {k: v for k, v in rep.items() if k == "head"}
    legacy["MLP_0"] = {"Dense_0": {"kernel": rep["trunk_kernel"]}, "LayerNorm_0": dict(rep["trunk_ln"])}
    params["world_model"]["rssm"]["representation_model"] = legacy
    old, _ = convert_dreamer_v3(params)
    new, _ = convert_dreamer_v3(agents["params"])
    assert old["world_model"].keys() == new["world_model"].keys()
    for k, v in new["world_model"].items():
        torch.testing.assert_close(old["world_model"][k], v, rtol=0, atol=0)


@pytest.mark.parametrize("B", [1, 16])
def test_the_cell_without_bias_and_its_gradients_match_the_pallas_cell(B):
    """DreamerV3's cell (no bias, LayerNorm, eps 1e-3) at a small H = X: the
    port's step and its hand VJP against the Pallas cell (interpret mode)
    and its ``custom_vjp``; the VJP gives no bias gradient and the
    LayerNorm's two."""
    from sheeprl_tpu.kernels import pallas_tpu
    from sheeprl_tpu_torch.kernels import ops

    Hs = Xs = 64
    rng = np.random.RandomState(B)
    h, x = rng.randn(B, Hs).astype(np.float32), rng.randn(B, Xs).astype(np.float32)
    kernel = (0.1 * rng.randn(Hs + Xs, 3 * Hs)).astype(np.float32)
    scale, shift = (1.0 + 0.1 * rng.randn(3 * Hs)).astype(np.float32), (0.1 * rng.randn(3 * Hs)).astype(np.float32)

    def loss(h, x, kernel, scale, shift):
        return jnp.sum(jnp.tanh(pallas_tpu.hafner_cell(h, x, kernel, None, scale, shift, hidden_size=Hs, eps=1e-3,
                                                       layer_norm=True, interpret=True)))

    want = jax.grad(loss, argnums=tuple(range(5)))(h, x, kernel, scale, shift)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (h, x, kernel, scale, shift)]
    out = ops.hafner_gru_cell(leaves[0], leaves[1], leaves[2], None, leaves[3], leaves[4], eps=1e-3)
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(pallas_tpu.hafner_cell(h, x, kernel, None, scale, shift, hidden_size=Hs, eps=1e-3,
                                          layer_norm=True, interpret=True)), **TOL,
    )
    got = torch.autograd.grad(torch.tanh(out).sum(), leaves)
    for name, g, w in zip(("h", "x", "kernel", "ln_scale", "ln_bias"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5, err_msg=name)
    grads = ops._HafnerCell.backward(
        type("Ctx", (), {"saved_tensors": (leaves[0].detach(), leaves[1].detach(), leaves[2].detach(), None,
                                           leaves[3].detach(), leaves[4].detach(),
                                           torch.cat([leaves[0], leaves[1]], -1).detach() @ leaves[2].detach()),
                         "needs_input_grad": (True,) * 6, "eps": 1e-3})(),
        torch.ones(B, Hs),
    )
    assert grads[3] is None and grads[4] is not None and grads[5] is not None

"""The port's DreamerV2 player step against the JAX composition.

Both sides get the same weights (the JAX ``build_agent`` at a small width,
carried across by ``convert_dreamer_v2``), the same uint8 frames and the
same pre-drawn Gumbel noise for the posterior sample; seeds are never
matched across frameworks. Three chained steps, with one row reset at the
second step.

Tolerances: recurrent state and posterior atol 1e-4 (float32 on the CPU,
XLA's and PyTorch's convolutions sum in different orders, over three
chained steps); the sampled categories and the actions must be equal.
"""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v2 import agent as jax_agent
from sheeprl_tpu.algos.dreamer_v2.utils import normalize_obs_jnp
from sheeprl_tpu.algos.dreamer_v3.agent import build_actor_dists as jax_actor_dists
from sheeprl_tpu.config import compose
from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_agent, build_player_fns
from sheeprl_tpu_torch.algos.dreamer_v2.utils import normalize_obs
from sheeprl_tpu_torch.configs import dreamer_v2_config
from sheeprl_tpu_torch.convert import convert_dreamer_v2

SMALL = {
    "algo.dense_units": 16,
    "algo.mlp_layers": 2,
    "algo.world_model.encoder.cnn_channels_multiplier": 4,
    "algo.world_model.recurrent_model.recurrent_state_size": 24,
    "algo.world_model.stochastic_size": 4,
    "algo.world_model.discrete_size": 5,
    "algo.world_model.transition_model.hidden_size": 20,
    "algo.world_model.representation_model.hidden_size": 20,
}
ACTIONS = (9,)
B = 3
TOL = dict(rtol=1e-4, atol=1e-4)


def _build(overrides, jax_space, torch_space, actions=ACTIONS, seed=3):
    """The JAX agent from ``build_agent`` and the port's agent with its
    weights carried across by ``convert_dreamer_v2``."""
    jcfg = compose(overrides=["exp=dreamer_v2_ms_pacman"] + [f"{k}={v}" for k, v in overrides.items()])
    wm, actor, _critic, params = jax_agent.build_agent(jcfg, actions, False, jax_space, jax.random.PRNGKey(seed))
    params = jax.device_get(params)
    state_dicts, skipped = convert_dreamer_v2(params)
    tcfg = dreamer_v2_config(**overrides)
    twm, tactor = build_agent(tcfg, actions, False, torch_space, device="cpu")
    twm.load_state_dict(state_dicts["world_model"])
    tactor.load_state_dict(state_dicts["actor"])
    return dict(jcfg=jcfg, wm=wm, actor=actor, params=params, tcfg=tcfg, twm=twm, tactor=tactor, skipped=skipped)


@pytest.fixture(scope="module")
def agents():
    obs_space = gym.spaces.Dict({"rgb": gym.spaces.Box(0, 255, (3, 64, 64), np.uint8)})
    return _build(SMALL, obs_space, {"rgb": (3, 64, 64)})


def _jax_step(a, state, obs, gumbel):
    p = {"params": a["params"]["world_model"]}
    wm = a["wm"]
    embed = wm.apply(p, obs, method=jax_agent.WorldModel.encode)
    rec = wm.apply(p, state["stochastic"], state["actions"], state["recurrent"], method=jax_agent.WorldModel.recurrent_step)
    _, post = wm.apply(
        p, rec, embed, None, gumbel,
        method=lambda m, r, e, k, g: m.rssm._representation(r, e, k, gumbel=g),
    )
    pre = a["actor"].apply({"params": a["params"]["actor"]}, jnp.concatenate([post, rec], -1))
    acts = [d.mode for d in jax_actor_dists(pre, False, "discrete", unimix=0.0)]
    return {"actions": jnp.concatenate(acts, -1), "recurrent": rec, "stochastic": post}


def test_player_step_matches_jax_composition(agents):
    a = agents
    S, D = SMALL["algo.world_model.stochastic_size"], SMALL["algo.world_model.discrete_size"]
    H = SMALL["algo.world_model.recurrent_model.recurrent_state_size"]
    fns = build_player_fns(a["twm"], a["tactor"], a["tcfg"], ACTIONS, False)
    rng = np.random.RandomState(11)
    tstate = fns["init_states"](B)
    jstate = {k: jnp.asarray(v.numpy()) for k, v in tstate.items()}
    for t in range(3):
        if t == 1:  # row 1 starts a new episode: its carried state is zeroed
            mask = np.array([0.0, 1.0, 0.0], np.float32)
            tstate = fns["reset_states"](tstate, torch.from_numpy(mask))
            jstate = jax.tree_util.tree_map(lambda s: (1.0 - mask[:, None]) * s, jstate)
        frames = {"rgb": rng.randint(0, 256, (B, 3, 64, 64)).astype(np.uint8)}
        gumbel = rng.gumbel(size=(B, S, D)).astype(np.float32)
        jstate = _jax_step(a, jstate, normalize_obs_jnp(frames, ["rgb"]), jnp.asarray(gumbel))
        actions, tstate = fns["greedy_action"](
            tstate, normalize_obs(frames, ["rgb"], torch.device("cpu")), gumbel=torch.from_numpy(gumbel)
        )
        assert tstate["recurrent"].shape == (B, H)
        np.testing.assert_allclose(tstate["recurrent"].numpy(), np.asarray(jstate["recurrent"]), **TOL)
        np.testing.assert_allclose(tstate["stochastic"].numpy(), np.asarray(jstate["stochastic"]), **TOL)
        np.testing.assert_array_equal(
            tstate["stochastic"].numpy().reshape(B, S, D).argmax(-1),
            np.asarray(jstate["stochastic"]).reshape(B, S, D).argmax(-1),
        )
        np.testing.assert_array_equal(actions[0].argmax(-1).numpy(), np.asarray(jstate["actions"]).argmax(-1))


def test_vector_observations_go_through_the_mlp_encoder():
    overrides = {**SMALL, "cnn_keys.encoder": [], "mlp_keys.encoder": ["state"]}
    space = gym.spaces.Dict({"state": gym.spaces.Box(-1, 1, (7,), np.float32)})
    a = _build(overrides, space, {"state": (7,)}, actions=(3,), seed=4)
    S, D = SMALL["algo.world_model.stochastic_size"], SMALL["algo.world_model.discrete_size"]
    fns = build_player_fns(a["twm"], a["tactor"], a["tcfg"], (3,), False)
    rng = np.random.RandomState(12)
    tstate = fns["init_states"](B)
    jstate = {k: jnp.asarray(v.numpy()) for k, v in tstate.items()}
    for _ in range(2):
        obs = {"state": rng.randn(B, 7).astype(np.float32)}
        gumbel = rng.gumbel(size=(B, S, D)).astype(np.float32)
        jstate = _jax_step(a, jstate, {"state": jnp.asarray(obs["state"])}, jnp.asarray(gumbel))
        actions, tstate = fns["greedy_action"](
            tstate, normalize_obs(obs, [], torch.device("cpu")), gumbel=torch.from_numpy(gumbel)
        )
        np.testing.assert_allclose(tstate["recurrent"].numpy(), np.asarray(jstate["recurrent"]), **TOL)
        np.testing.assert_allclose(tstate["stochastic"].numpy(), np.asarray(jstate["stochastic"]), **TOL)
        np.testing.assert_array_equal(actions[0].argmax(-1).numpy(), np.asarray(jstate["actions"]).argmax(-1))


@pytest.mark.parametrize("sample", [True, False], ids=["sample", "mode"])
def test_transition_matches_jax(agents, sample):
    a = agents
    S, D = SMALL["algo.world_model.stochastic_size"], SMALL["algo.world_model.discrete_size"]
    H = SMALL["algo.world_model.recurrent_model.recurrent_state_size"]
    rng = np.random.RandomState(13)
    rec = rng.randn(B, H).astype(np.float32)
    gumbel = rng.gumbel(size=(B, S, D)).astype(np.float32)
    j_logits, j_state = a["wm"].apply(
        {"params": a["params"]["world_model"]}, jnp.asarray(rec), None, sample, jnp.asarray(gumbel),
        method=lambda m, r, k, s, g: m.rssm._transition(r, k, sample_state=s, gumbel=g),
    )
    with torch.inference_mode():
        t_logits, t_state = a["twm"].rssm._transition(
            torch.from_numpy(rec), sample_state=sample, gumbel=torch.from_numpy(gumbel)
        )
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **TOL)
    np.testing.assert_allclose(t_state.numpy(), np.asarray(j_state), **TOL)


def test_converter_skips_training_parts_explicitly(agents):
    skipped = agents["skipped"]
    assert any(p.startswith("world_model/cnn_decoder/") for p in skipped)
    assert any(p.startswith("world_model/reward_model/") for p in skipped)
    assert any(p.startswith("world_model/continue_model/") for p in skipped)
    assert any(p.startswith("critic/") for p in skipped) and any(p.startswith("target_critic/") for p in skipped)
    assert not any("rssm" in p or p.startswith("actor/") for p in skipped)


def test_converter_raises_on_unknown_leaf(agents):
    params = jax.tree_util.tree_map(lambda x: x, agents["params"])
    params["world_model"]["rssm"]["mystery"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="mystery"):
        convert_dreamer_v2(params)
    with pytest.raises(KeyError, match="unknown param tree"):
        convert_dreamer_v2({**agents["params"], "optimizer": {}})


def test_posterior_sample_from_generator_is_reproducible(agents):
    fns = build_player_fns(agents["twm"], agents["tactor"], agents["tcfg"], ACTIONS, False)
    frames = {"rgb": np.random.RandomState(0).randint(0, 256, (B, 3, 64, 64)).astype(np.uint8)}
    obs = normalize_obs(frames, ["rgb"], torch.device("cpu"))
    runs = [
        fns["greedy_action"](fns["init_states"](B), obs, torch.Generator().manual_seed(7))[1]["stochastic"]
        for _ in range(2)
    ]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _jax_names(value):
    """``value`` with the port's ``_target_`` prefix renamed to the JAX package's."""
    if isinstance(value, dict):
        return {k: _jax_names(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jax_names(v) for v in value]
    if isinstance(value, str) and value.startswith("sheeprl_tpu_torch."):
        return "sheeprl_tpu." + value[len("sheeprl_tpu_torch."):]
    return value


@pytest.mark.parametrize(
    "exp,overrides",
    [
        ("dreamer_v2_ms_pacman", {}),
        (
            "dreamer_v2",
            {
                "seed": 42,
                "env.id": "discrete_dummy",
                "per_rank_batch_size": 16,
                "algo.gamma": 0.99,
                "algo.world_model.use_continues": False,
                "algo.world_model.kl_free_nats": 1.0,
                "algo.world_model.kl_regularizer": 1.0,
                "algo.world_model.discount_scale_factor": 1.0,
                "algo.world_model.optimizer.lr": 3e-4,
                "algo.actor.ent_coef": 1e-4,
                "algo.actor.optimizer.lr": 8e-5,
                "algo.critic.optimizer.lr": 8e-5,
            },
        ),
    ],
)
def test_config_matches_composed_yaml(exp, overrides):
    """Every leaf of the port's composed preset equals the JAX package's
    compose of the same experiment and overrides (targets renamed; the
    clock-stamped run name aside)."""
    ours = _leaves(dreamer_v2_config(exp=exp, **overrides))
    theirs = _leaves(compose(overrides=[f"exp={exp}"] + [f"{k}={v}" for k, v in overrides.items()]))
    assert ours.keys() == theirs.keys()
    for key, value in ours.items():
        want = theirs[key]
        if key == "run_name":
            continue
        assert _jax_names(value) == want, f"{key}: port {value!r} vs composed {want!r}"


def test_config_rejects_unknown_keys():
    with pytest.raises(KeyError):
        dreamer_v2_config(**{"algo.not_a_field": 1})


@pytest.mark.parametrize("expl_amount", [0.0, 0.5, 1.0])
def test_exploration_action_matches_jax_composition(agents, expl_amount):
    """The training player's step at injected noise: the posterior and the
    action sampled from the same Gumbel noise as the JAX composition, then
    ``add_exploration_noise``'s mix (a uniform category where ``u <
    expl_amount``) from the same injected draws."""
    a = agents
    S, D = SMALL["algo.world_model.stochastic_size"], SMALL["algo.world_model.discrete_size"]
    fns = build_player_fns(a["twm"], a["tactor"], a["tcfg"], ACTIONS, False)
    rng = np.random.RandomState(14)
    frames = {"rgb": rng.randint(0, 256, (B, 3, 64, 64)).astype(np.uint8)}
    gumbel = rng.gumbel(size=(B, S, D)).astype(np.float32)
    action_gumbel = rng.gumbel(size=(B, ACTIONS[0])).astype(np.float32)
    category = rng.randint(0, ACTIONS[0], size=B)
    u = rng.uniform(size=(B, 1)).astype(np.float32)

    tstate = fns["init_states"](B)
    jstate = {k: jnp.asarray(v.numpy()) for k, v in tstate.items()}
    p = {"params": a["params"]["world_model"]}
    embed = a["wm"].apply(p, normalize_obs_jnp(frames, ["rgb"]), method=jax_agent.WorldModel.encode)
    rec = a["wm"].apply(p, jstate["stochastic"], jstate["actions"], jstate["recurrent"],
                        method=jax_agent.WorldModel.recurrent_step)
    _, post = a["wm"].apply(p, rec, embed, None, jnp.asarray(gumbel),
                            method=lambda m, r, e, k, g: m.rssm._representation(r, e, k, gumbel=g))
    pre = a["actor"].apply({"params": a["params"]["actor"]}, jnp.concatenate([post, rec], -1))
    logits = np.asarray(jax_actor_dists(pre, False, "discrete", unimix=0.0)[0].logits)
    sampled = np.eye(ACTIONS[0], dtype=np.float32)[(logits + action_gumbel).argmax(-1)]
    want = np.where(u < expl_amount, np.eye(ACTIONS[0], dtype=np.float32)[category], sampled)

    actions, new_state = fns["exploration_action"](
        tstate, normalize_obs(frames, ["rgb"], torch.device("cpu")), expl_amount,
        gumbel=torch.from_numpy(gumbel), action_gumbels=[torch.from_numpy(action_gumbel)],
        expl_noise=[(torch.from_numpy(category), torch.from_numpy(u))],
    )
    np.testing.assert_allclose(actions[0].numpy(), want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(new_state["actions"].numpy().argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(new_state["recurrent"].numpy(), np.asarray(rec), **TOL)
    np.testing.assert_allclose(new_state["stochastic"].numpy(), np.asarray(post), **TOL)


def test_exploration_action_draws_from_its_generator(agents):
    fns = build_player_fns(agents["twm"], agents["tactor"], agents["tcfg"], ACTIONS, False)
    obs = normalize_obs({"rgb": np.zeros((B, 3, 64, 64), np.uint8)}, ["rgb"], torch.device("cpu"))
    runs = [
        fns["exploration_action"](fns["init_states"](B), obs, 0.5, torch.Generator().manual_seed(3))[0][0]
        for _ in range(2)
    ]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
    assert torch.equal(runs[0].sum(-1), torch.ones(B))

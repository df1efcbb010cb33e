"""DreamerV3 on the real-simulator wrappers through the port, on the CPU at
small widths, over the stand-in simulators (``tests/sim_stubs.py``; the
fixture of ``test_torch_envs_sims.py``):

- MineDojo's masked player against the JAX player composed from its
  methods, at injected noise (the posterior's Gumbels; each head's sampling
  Gumbels and the exploration draw re-derived from the JAX keys), greedy and
  exploring, with the env's masks, and without them as the unmasked player;
- (one acting and one training step of both CLIs on MineDojo:
  ``test_torch_dreamer_v3_minedojo_cli.py``);
- the L DIAMBRA, XL Crafter and L Navigate presets through the port's CLI on
  the port's wrappers, and ``exp=dreamer_v3_L_navigate`` composing in both
  packages to the same env and algo trees;
- ``available_agents`` printing every registered entrypoint without ``rich``.

Tolerances: actions exactly (argmax); recurrent and stochastic states rtol
and atol 1e-4 (float32, XLA and PyTorch sum in other orders), as the DV3
player parity test holds them."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import cpu_threads  # noqa: F401  (one CPU thread a process: see cpu_threads.py)
import pytest
import torch
from jax_jit_build import jit_build
from test_torch_envs_sims import sims  # noqa: F401  (the stand-in simulators fixture)

from sheeprl_tpu.algos.dreamer_v3 import agent as jax_agent
from sheeprl_tpu.algos.dreamer_v3 import minedojo_actor as jax_md
from sheeprl_tpu.algos.dreamer_v3.utils import normalize_obs_jnp
from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu_torch import available_agents, cli
from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent, build_player_fns
from sheeprl_tpu_torch.algos.dreamer_v3.utils import normalize_obs
from sheeprl_tpu_torch.ckpt import read_checkpoint
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.configs import dreamer_v3_config
from sheeprl_tpu_torch.convert import convert_dreamer_v3
import sim_stubs

N_ITEMS, N_CRAFT = len(sim_stubs.MC_ITEMS), len(sim_stubs.MINEDOJO_CRAFT_SMELT)
ACTIONS = (19, N_CRAFT, N_ITEMS)
MLP = ["inventory", "inventory_max", "equipment", "life_stats"]
SMALL = {
    "algo.dense_units": 16,
    "algo.mlp_layers": 1,
    "algo.world_model.encoder.cnn_channels_multiplier": 4,
    "algo.world_model.recurrent_model.recurrent_state_size": 24,
    "algo.world_model.stochastic_size": 4,
    "algo.world_model.discrete_size": 5,
    "algo.world_model.transition_model.hidden_size": 20,
    "algo.world_model.representation_model.hidden_size": 20,
    "cnn_keys.encoder": ["rgb"],
    "mlp_keys.encoder": MLP,
    "cnn_keys.decoder": ["rgb"],
    "mlp_keys.decoder": MLP,
}
OBS = {"rgb": (3, 64, 64), "inventory": (N_ITEMS,), "inventory_max": (N_ITEMS,), "equipment": (N_ITEMS,),
       "life_stats": (3,)}
B, S, D = 4, 4, 5
TOL = dict(rtol=1e-4, atol=1e-4)


def _space():
    import gymnasium as gym

    box = {k: gym.spaces.Box(0, 255, s, np.uint8) if k == "rgb" else gym.spaces.Box(-np.inf, np.inf, s, np.float32)
           for k, s in OBS.items()}
    return gym.spaces.Dict(box)


@pytest.fixture(scope="module")
def agents():
    overrides = [f"{k}={v}" for k, v in SMALL.items()]
    jcfg = jax_compose(overrides=["exp=dreamer_v3", "env=dummy", *overrides])
    wm, actor, _critic, params = jit_build(jax_agent.build_agent, jcfg, ACTIONS, False, _space(), jax.random.PRNGKey(4))
    params = jax.device_get(params)
    state_dicts, _ = convert_dreamer_v3(params, training=False)
    tcfg = dreamer_v3_config(**SMALL)
    tcfg.env.wrapper._target_ = "sheeprl_tpu_torch.envs.minedojo.MineDojoWrapper"
    twm, tactor = build_agent(tcfg, ACTIONS, False, OBS, device="cpu", training=False)
    twm.load_state_dict(state_dicts["world_model"])
    tactor.load_state_dict(state_dicts["actor"])
    return dict(jcfg=jcfg, wm=wm, actor=actor, params=params, tcfg=tcfg, twm=twm, tactor=tactor)


def _frames(rng):
    out = {"rgb": rng.integers(0, 256, (B, 3, 64, 64)).astype(np.uint8)}
    out.update({k: rng.normal(size=(B,) + s).astype(np.float32) for k, s in OBS.items() if k != "rgb"})
    return out


def _masks(rng):
    m = {"mask_action_type": np.ones((B, 19), bool), "mask_craft_smelt": rng.random((B, N_CRAFT)) < 0.3,
         "mask_equip_place": rng.random((B, N_ITEMS)) < 0.1, "mask_destroy": rng.random((B, N_ITEMS)) < 0.1}
    m["mask_action_type"][:, 15:] = rng.random((B, 4)) < 0.5
    m["mask_craft_smelt"][0] = m["mask_equip_place"][1] = m["mask_destroy"][2] = False
    return m


def _wm(a, method, *args):
    return a["wm"].apply({"params": a["params"]["world_model"]}, *args, method=method)


def _jax_step(a, state, obs, gumbel, key, masks, greedy, expl_amount):
    """The JAX player's ``_step`` and exploration on MineDojo, composed from its methods: the posterior at
    injected Gumbels, the heads through ``sample_minedojo_actions`` (key ``k_act``) and the exploration through
    ``add_minedojo_exploration_noise`` (key ``k_expl``)."""
    jw = jax_agent.WorldModel
    embed = _wm(a, jw.encode, obs)
    rec = _wm(a, jw.recurrent_step, state["stochastic"], state["actions"], state["recurrent"])
    _, post = a["wm"].apply(
        {"params": a["params"]["world_model"]}, rec, embed, jnp.asarray(gumbel),
        method=lambda m, r, e, g: m.rssm._representation_projected(r, m.rssm.project_embed(e), None, gumbel=g),
    )
    pre = a["actor"].apply({"params": a["params"]["actor"]}, jnp.concatenate([post, rec], -1))
    k_act, k_expl = jax.random.split(key)
    jm = None if masks is None else {k: jnp.asarray(v) for k, v in masks.items()}
    if jm is None:
        dists = jax_agent.build_actor_dists(pre, False, "discrete", unimix=0.01)
        actions = jax_agent.sample_actor_actions(dists, False, k_act, not greedy)
        if not greedy:
            actions = jax_agent.add_exploration_noise(actions, jnp.float32(expl_amount), False, k_expl)
    else:
        actions, _ = jax_md.sample_minedojo_actions(pre, jm, k_act, 0.01, not greedy)
        if not greedy:
            actions = jax_md.add_minedojo_exploration_noise(actions, jnp.float32(expl_amount), jm, k_expl)
    return actions, {"actions": jnp.concatenate(actions, -1), "recurrent": rec, "stochastic": post}


def _port_noise(key, pre_shapes, expl, masked):
    """The JAX step's keys as the port's pre-drawn noise: each head's sampling Gumbels, and the exploration
    draw (the masked one's Gumbels and u a head; the unmasked one's uniform category and u)."""
    k_act, k_expl = jax.random.split(key)
    ka = jax.random.split(k_act, len(pre_shapes))
    action_gumbels = [torch.from_numpy(np.array(jax.random.gumbel(k, s, jnp.float32))) for k, s in zip(ka, pre_shapes)]
    ke = jax.random.split(k_expl, 2 * len(pre_shapes))
    expl_noise = []
    for i, s in enumerate(pre_shapes):
        gumbel = np.array(jax.random.gumbel(ke[2 * i], s, jnp.float32))
        u = torch.from_numpy(np.array(jax.random.uniform(ke[2 * i + 1], s[:-1] + (1,))))
        expl_noise.append((torch.from_numpy(gumbel), u) if masked else (torch.from_numpy(gumbel.argmax(-1)), u))
    return action_gumbels, expl_noise


@pytest.mark.parametrize("mode", ["greedy", "exploring", "unmasked"])
def test_the_masked_player_matches_jax_at_injected_noise(agents, mode):
    """Four chained player steps of the port's MineDojo player (masked: it is built for the MineDojo wrapper's
    ``_target_``) against JAX's; ``unmasked`` gives no masks, so both act as the plain player."""
    a = agents
    fns = build_player_fns(a["twm"], a["tactor"], a["tcfg"], ACTIONS, False)
    rng = np.random.default_rng(9)
    tstate = fns["init_states"](B)
    jstate = {k: jnp.asarray(v.numpy()) for k, v in tstate.items()}
    for t in range(4):
        frames, masks = _frames(rng), (None if mode == "unmasked" else _masks(rng))
        gumbel = rng.gumbel(size=(B, S, D)).astype(np.float32)
        key = jax.random.PRNGKey(100 + t)
        j_actions, jstate = _jax_step(a, jstate, normalize_obs_jnp(frames, ["rgb"]), gumbel, key, masks,
                                      mode == "greedy", 0.5)
        obs = normalize_obs(frames, ["rgb"], torch.device("cpu"))
        tmasks = None if masks is None else {k: torch.from_numpy(v) for k, v in masks.items()}
        if mode == "greedy":
            actions, tstate = fns["greedy_action"](tstate, obs, gumbel=torch.from_numpy(gumbel), masks=tmasks)
        else:
            action_gumbels, expl_noise = _port_noise(key, [(B, d) for d in ACTIONS], 0.5, masks is not None)
            actions, tstate = fns["exploration_action"](tstate, obs, 0.5, gumbel=torch.from_numpy(gumbel),
                                                        action_gumbels=action_gumbels, expl_noise=expl_noise,
                                                        masks=tmasks)
        for p, j in zip(actions, j_actions):
            np.testing.assert_array_equal(p.numpy().argmax(-1), np.asarray(j).argmax(-1))
        np.testing.assert_allclose(tstate["recurrent"].numpy(), np.asarray(jstate["recurrent"]), **TOL)
        np.testing.assert_allclose(tstate["stochastic"].numpy(), np.asarray(jstate["stochastic"]), **TOL)
        if masks is not None:
            types = actions[0].argmax(-1).numpy()
            assert masks["mask_action_type"][np.arange(B), types].all()


# ---------------------------------------------------------------------------
# the L / XL presets on the port's wrappers
# ---------------------------------------------------------------------------

SMALL_CLI = [
    "algo.dense_units=8", "algo.mlp_layers=1", "algo.world_model.encoder.cnn_channels_multiplier=2",
    "algo.world_model.recurrent_model.recurrent_state_size=8", "algo.world_model.transition_model.hidden_size=8",
    "algo.world_model.representation_model.hidden_size=8", "algo.world_model.stochastic_size=4",
    "algo.world_model.discrete_size=4", "algo.horizon=3", "per_rank_sequence_length=8", "per_rank_batch_size=2",
    "fabric.accelerator=cpu", "env.sync_env=True", "env.capture_video=False", "buffer.size=512",
    "metric.log_level=0", "buffer.checkpoint=True",
]
PRESETS = {
    "dreamer_v3_L_doapp": (["algo.learning_starts=64", "total_steps=88"], ("frame", "P1_ownHealth", "stage")),
    # the preset's env.id "reward" is no Crafter id the wrappers take (the JAX wrapper raises on it too): the
    # run names the preset's task, crafter_reward
    "dreamer_v3_XL_crafter": (["algo.learning_starts=16", "total_steps=22", "env.id=crafter_reward"],
                              ("rgb", "reward")),
    "dreamer_v3_L_navigate": (["algo.learning_starts=32", "total_steps=72"],
                              ("rgb", "life_stats", "inventory", "max_inventory", "compass", "reward")),
}


@pytest.mark.parametrize("exp", sorted(PRESETS))
def test_the_L_and_XL_presets_run_on_the_port_wrappers(sims, tmp_path, exp):
    extra, keys = PRESETS[exp]
    result = cli.run([f"exp={exp}", f"root_dir={tmp_path}", "run_name=r"] + SMALL_CLI + extra)
    assert result["gradient_steps"] >= 3 and result["test_steps"] == sim_stubs.EPISODE_STEPS
    rb = read_checkpoint(result["checkpoint"], with_rb=True)["rb"]
    flat = str(rb)
    for k in keys:
        assert k in flat, k


def test_the_navigate_preset_composes_alike_in_both_packages():
    def tree(cfg, part):
        text = repr(cfg[part].as_dict() if hasattr(cfg[part], "as_dict") else dict(cfg[part]))
        return text.replace("sheeprl_tpu_torch.", "sheeprl_tpu.")

    port, jax_cfg = compose(overrides=["exp=dreamer_v3_L_navigate"]), jax_compose(overrides=["exp=dreamer_v3_L_navigate"])
    for part in ("env", "algo", "cnn_keys", "mlp_keys"):
        assert tree(port, part) == tree(jax_cfg, part), part
    assert port.env.wrapper._target_ == "sheeprl_tpu_torch.envs.minerl.MineRLWrapper"
    assert port.algo.world_model.recurrent_model.recurrent_state_size == 2048 and port.algo.dense_units == 768


def test_available_agents_prints_every_entrypoint_without_rich(monkeypatch, capsys):
    import sheeprl_tpu_torch
    from sheeprl_tpu_torch.utils.registry import algorithm_registry, evaluation_registry

    monkeypatch.setitem(sys.modules, "rich", None)
    monkeypatch.setitem(sys.modules, "rich.console", None)
    monkeypatch.setitem(sys.modules, "rich.table", None)
    available_agents.main()
    out = capsys.readouterr().out
    sheeprl_tpu_torch.register_algorithms()
    lines = out.splitlines()
    assert lines[0] == available_agents.TITLE and lines[1].split() == ["Module", "Algorithm", "Entrypoint",
                                                                        "Decoupled", "Evaluated", "by"]
    names = [a["name"] for algos in algorithm_registry.values() for a in algos]
    assert len(names) == 17 and len(lines) == 3 + len(names)
    for module, algos in algorithm_registry.items():
        for algo in algos:
            row = next(line.split() for line in lines[3:] if line.split()[:2] == [module, algo["name"]])
            evals = [f"{m}.{e['entrypoint']}" for m, es in evaluation_registry.items() for e in es
                     if e["name"] == algo["name"]]
            assert row[2:] == [algo["entrypoint"], str(algo["decoupled"]), evals[0] if evals else "Undefined"]

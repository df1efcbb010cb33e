"""The port's real-simulator wrappers (``sheeprl_tpu_torch/envs/{crafter,
diambra,minerl,minedojo}.py`` and ``envs/minerl_envs/``) against the JAX
package's, over the stand-in simulators of ``tests/sim_stubs.py``.

A fixture installs the stubs in ``sys.modules`` with gymnasium's spaces (as
the real packages hand out, and as the JAX wrappers' ``isinstance`` checks
need) and reloads both packages' import probes; its teardown takes the stubs
and every wrapper module imported over them out again and reloads the probes,
so that a later test on the same worker sees no simulator. Each wrapper pair
runs over two stub envs of one seed with one seeded script of actions
(numpy): every step must give equal observations (keys, dtypes, shapes,
values), rewards, ``terminated``/``truncated``, infos, and the same converted
action reaching the simulator. Exact equality throughout: the wrappers do the
same numpy arithmetic."""

import importlib
import itertools
import sys
import warnings

import numpy as np
import cpu_threads  # noqa: F401  (one CPU thread a process: see cpu_threads.py)
import pytest

from sheeprl_tpu_torch.config import compose
import sim_stubs
from sheeprl_tpu_torch.envs.wrappers import Env

WRAPPERS = ("crafter", "diambra", "minerl", "minedojo")


def _reload_probes():
    for name in ("sheeprl_tpu.utils.imports", "sheeprl_tpu_torch.utils.imports"):
        importlib.reload(importlib.import_module(name))


def _drop_wrapper_modules():
    for pkg in ("sheeprl_tpu.envs.", "sheeprl_tpu_torch.envs."):
        for stem in ("crafter", "diambra", "minerl", "minedojo"):
            for m in [m for m in sys.modules if m == pkg + stem or m.startswith(pkg + stem + ".")
                      or m.startswith(pkg + "minerl_envs")]:
                sys.modules.pop(m, None)


@pytest.fixture
def sims():
    """The four stand-ins in ``sys.modules`` (gymnasium spaces), both probes reloaded; all undone on teardown."""
    _drop_wrapper_modules()
    mods = sim_stubs.install(gymnasium=True)
    _reload_probes()
    try:
        yield mods
    finally:
        sim_stubs.uninstall()
        _drop_wrapper_modules()
        _reload_probes()


def _pair(name):
    return (importlib.import_module(f"sheeprl_tpu.envs.{name}"), importlib.import_module(f"sheeprl_tpu_torch.envs.{name}"))


def _fresh_seeds(sims, name):
    sims[name].next_seed = itertools.count()


def _same(a, b, where=""):
    """Recursive exact equality of observations, infos and actions (dtypes and shapes of arrays too)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (where, sorted(a), sorted(b))
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), (where, type(b))
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype, a.shape, b.shape)
        assert np.array_equal(a, b), where
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def _same_spaces(port_space, jax_space):
    """The port's space against a gymnasium one: kind, shape, dtype, bounds, n / nvec."""
    kind = type(jax_space).__name__
    assert type(port_space).__name__ == kind
    if kind == "Dict":
        assert set(port_space.spaces) == set(jax_space.spaces)
        for k in jax_space.spaces:
            _same_spaces(port_space[k], jax_space[k])
    elif kind == "Box":
        assert port_space.shape == jax_space.shape and port_space.dtype == jax_space.dtype
        assert np.array_equal(port_space.low, jax_space.low) and np.array_equal(port_space.high, jax_space.high)
    elif kind == "Discrete":
        assert port_space.n == jax_space.n
    else:
        assert np.array_equal(port_space.nvec, jax_space.nvec)


def _run_pair(jax_env, port_env, actions):
    """Both envs reset, then stepped by the same actions (reset together when an episode ends): returns the steps."""
    assert isinstance(port_env, Env) and not isinstance(jax_env, Env)
    _same_spaces(port_env.observation_space, jax_env.observation_space)
    _same_spaces(port_env.action_space, jax_env.action_space)
    (jo, ji), (po, pi) = jax_env.reset(seed=None), port_env.reset(seed=None)
    _same(jo, po, "reset obs")
    _same(ji, pi, "reset info")
    steps = []
    for t, action in enumerate(actions):
        action = action(jo) if callable(action) else action
        j, p = jax_env.step(np.array(action, copy=True)), port_env.step(np.array(action, copy=True))
        _same(j[0], p[0], f"step {t} obs")
        assert j[1] == p[1] and bool(j[2]) == bool(p[2]) and bool(j[3]) == bool(p[3]), (t, j[1:4], p[1:4])
        _same(j[4], p[4], f"step {t} info")
        steps.append((action, j))
        jo = j[0]
        if j[2] or j[3]:
            (jo, ji), (po, pi) = jax_env.reset(seed=None), port_env.reset(seed=None)
            _same(jo, po, "reset obs")
    return steps


def _received(wrapper):
    return wrapper.env.received


# ---------------------------------------------------------------------------
# import gating, probes, composition
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", WRAPPERS + ("minerl_envs.backend", "minerl_envs.navigate", "minerl_envs.obtain"))
def test_without_a_simulator_each_wrapper_raises_at_import_as_in_jax(name):
    from sheeprl_tpu_torch.utils import imports

    flag = {"crafter": "_IS_CRAFTER_AVAILABLE", "diambra": "_IS_DIAMBRA_AVAILABLE",
            "minedojo": "_IS_MINEDOJO_AVAILABLE"}.get(name, "_IS_MINERL_AVAILABLE")
    assert getattr(imports, flag) is False  # neither machine has the simulators
    for pkg in ("sheeprl_tpu", "sheeprl_tpu_torch"):
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(f"{pkg}.envs.{name}")


def test_the_probes_match_jax_and_see_a_stub_in_sys_modules(sims):
    from sheeprl_tpu.utils import imports as jax_imports
    from sheeprl_tpu_torch.utils import imports

    names = [n for n in dir(jax_imports) if n.startswith("_IS_")]
    assert names == [n for n in dir(imports) if n.startswith("_IS_")]
    assert {n: getattr(imports, n) for n in names} == {n: getattr(jax_imports, n) for n in names}
    for flag in ("_IS_CRAFTER_AVAILABLE", "_IS_DIAMBRA_AVAILABLE", "_IS_DIAMBRA_ARENA_AVAILABLE",
                 "_IS_MINEDOJO_AVAILABLE", "_IS_MINERL_AVAILABLE"):
        assert getattr(imports, flag) is True
    assert imports._module_available("minerl.herobraine.hero.mc")
    assert not imports._module_available("not_a_simulator")


@pytest.mark.parametrize("env", WRAPPERS)
def test_each_env_config_composes_and_builds_through_the_port(sims, env):
    """``env=<simulator>`` composes in the port and builds the whole env pipeline (``utils.env.build_env``)
    over the stub, its observation keys those of the JAX wrapper, its frames CHW at the screen size."""
    from sheeprl_tpu_torch.utils.env import build_env

    overrides = ["exp=dreamer_v3", f"env={env}", "env.capture_video=False", "env.sync_env=True"]
    cfg = compose(overrides=overrides + ["cnn_keys.encoder=[rgb]"])
    if env == "diambra":
        cfg = compose(overrides=overrides + ["cnn_keys.encoder=[frame]"])
    assert cfg.env.wrapper._target_.startswith(f"sheeprl_tpu_torch.envs.{env}.")
    built = build_env(cfg, seed=3, rank=0)
    obs, _ = built.reset(seed=3)
    key = cfg.cnn_keys.encoder[0]
    assert obs[key].shape == (3, cfg.env.screen_size, cfg.env.screen_size) and obs[key].dtype == np.uint8
    assert set(obs) == set(built.observation_space.spaces)
    action = built.action_space.sample()
    if env == "minedojo":
        action = np.zeros(3, np.int64)  # a no-op is valid under any mask
    for _ in range(3):
        obs, reward, terminated, truncated, info = built.step(action)
    assert np.isfinite(reward) and set(obs) == set(built.observation_space.spaces)


# ---------------------------------------------------------------------------
# Crafter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("env_id", ["crafter_reward", "crafter_nonreward"])
def test_crafter_matches_jax(sims, env_id):
    jax_mod, port_mod = _pair("crafter")
    jax_env = jax_mod.CrafterWrapper(env_id, screen_size=64, seed=7)
    port_env = port_mod.CrafterWrapper(env_id, screen_size=64, seed=7)
    assert port_env.reward_range == jax_env.reward_range and port_env.render_mode == jax_env.render_mode
    rng = np.random.default_rng(0)
    _run_pair(jax_env, port_env, rng.integers(0, 17, (70, 1)))
    _same(_received(jax_env), _received(port_env), "received")
    assert len(_received(port_env)) == 70
    _same(jax_env.render(), port_env.render(), "render")
    with pytest.raises(ValueError, match="Unknown crafter id"):
        port_mod.CrafterWrapper("crafter_other", screen_size=64)
    with pytest.raises(ValueError, match="outside Discrete"):
        port_env.step(17)


# ---------------------------------------------------------------------------
# DIAMBRA
# ---------------------------------------------------------------------------

DIAMBRA_SETTINGS = {"role": "diambra.arena.Roles.P1", "step_ratio": 6, "difficulty": 4, "continue_game": 0.0,
                    "show_final": False, "outfits": 4, "splash_screen": False}
DIAMBRA_WRAPPERS = {"stack_actions": 1, "no_op_max": 0, "no_attack_buttons_combinations": False,
                    "add_last_action": True, "scale": False, "exclude_image_scaling": False,
                    "process_discrete_binary": False, "role_relative": True}


def _diambra(mod, case):
    settings, wrappers = dict(DIAMBRA_SETTINGS), dict(DIAMBRA_WRAPPERS)
    kwargs = dict(screen_size=64, grayscale=False, repeat_action=1, rank=2, increase_performance=True)
    if case == "disabled_settings":  # each disabled setting and wrapper warns and is dropped; sticky actions
        settings.update(frame_shape=(128, 128, 1), n_players=2)
        wrappers.update(frame_shape=(32, 32, 0), stack_frames=4, dilation=2, flatten=False)
        kwargs.update(repeat_action=4)
    elif case == "wrapper_resizes":
        kwargs.update(increase_performance=False, grayscale=True, screen_size=(48, 40))
    elif case == "multi_discrete":
        kwargs.update(action_space="diambra.arena.SpaceTypes.MULTI_DISCRETE")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        env = mod.DiambraWrapper("doapp", diambra_settings=settings, diambra_wrappers=wrappers, **kwargs)
    return env, [str(w.message) for w in caught]


@pytest.mark.parametrize("case", ["defaults", "disabled_settings", "wrapper_resizes", "multi_discrete"])
def test_diambra_matches_jax(sims, case):
    jax_mod, port_mod = _pair("diambra")
    (jax_env, jax_warned), (port_env, port_warned) = _diambra(jax_mod, case), _diambra(port_mod, case)
    assert port_warned == jax_warned
    if case == "disabled_settings":
        assert len(port_warned) == 7 and any("step_ratio modified to 1" in w for w in port_warned)
    for side in ("settings", "wrappers"):  # what reached the engine
        _same(getattr(jax_env.env, side).as_dict(), getattr(port_env.env, side).as_dict(), side)
    engine = port_env.env.settings.as_dict()
    assert engine["step_ratio"] == (1 if case == "disabled_settings" else 6)
    assert "n_players" in engine and engine["n_players"] == 1 and engine["role"] == DIAMBRA_SETTINGS["role"]
    resized = port_env.env.settings if case != "wrapper_resizes" else port_env.env.wrappers
    assert tuple(resized.frame_shape) == ((48, 40, 1) if case == "wrapper_resizes" else (64, 64, 0))
    rng = np.random.default_rng(1)
    if case == "multi_discrete":
        actions = np.stack([rng.integers(0, 9, 50), rng.integers(0, 8, 50)], -1)
    else:
        actions = rng.integers(0, sim_stubs.DOAPP_ACTIONS, (50, 1))
    steps = _run_pair(jax_env, port_env, actions)
    assert any(s[1][2] for s in steps)  # a round ended through the engine's env_done
    _same(_received(jax_env), _received(port_env), "received")
    _same(jax_env.render(), port_env.render(), "render")


# ---------------------------------------------------------------------------
# MineRL and its env specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec,kwargs", [
    ("CustomNavigate", {"dense": True, "extreme": False}),
    ("CustomNavigate", {"dense": False, "extreme": True}),
    ("CustomObtainDiamond", {"dense": True}),
    ("CustomObtainIronPickaxe", {"dense": False}),
])
def test_env_specs_build_the_jax_handler_lists(sims, spec, kwargs):
    module = "navigate" if spec == "CustomNavigate" else "obtain"
    jax_spec = getattr(importlib.import_module(f"sheeprl_tpu.envs.minerl_envs.{module}"), spec)(
        break_speed=100, **kwargs)
    port_spec = getattr(importlib.import_module(f"sheeprl_tpu_torch.envs.minerl_envs.{module}"), spec)(
        break_speed=100, **kwargs)
    assert port_spec.name == jax_spec.name and port_spec.max_episode_steps == jax_spec.max_episode_steps
    _same(jax_spec.handler_lists(), port_spec.handler_lists(), "handlers")
    assert port_spec.handler_lists()["agent_start"][0] == ("BreakSpeedMultiplier", (), {"multiplier": 100})
    assert port_spec.agent_start[0].to_string() == jax_spec.agent_start[0].to_string() == "break_speed(100)"
    rewards = [100.0, 60.0] if spec == "CustomNavigate" else [s["reward"] for s in jax_spec.reward_schedule]
    assert port_spec.determine_success_from_rewards(rewards) == jax_spec.determine_success_from_rewards(rewards)
    assert port_spec.get_docstring() == jax_spec.get_docstring()
    for folder in ("navigate", "navigateextreme", "o_dia", "o_iron", "o_iron_pickaxe"):
        assert port_spec.is_from_folder(folder) == jax_spec.is_from_folder(folder)


def _minerl_script(env, n, rng):
    """Pitch moves past the limits, yaw moves round the circle, attack then no-ops (sticky attack), jump then no-ops
    (sticky jump), then seeded random actions."""
    index = {repr(sorted((k, np.asarray(v).tolist()) for k, v in e.items())): i for i, e in env.ACTIONS_MAP.items()}

    def find(entry):
        return index[repr(sorted((k, np.asarray(v).tolist()) for k, v in entry.items()))]

    up, yaw = find({"camera": np.array([-15, 0])}), find({"camera": np.array([0, 15])})
    attack, jump = find({"attack": 1}), find({"jump": 1, "forward": 1})
    head = [up] * 6 + [yaw] * 14 + [attack] + [0] * 11 + [jump] + [0] * 3  # the jump opens the second episode
    tail = rng.integers(0, len(env.ACTIONS_MAP), n - len(head)).tolist()
    return [np.array([a]) for a in head + tail]


@pytest.mark.parametrize("env_id,multihot", [
    ("custom_navigate", False), ("custom_navigate", True), ("custom_obtain_diamond", False),
    ("custom_obtain_iron_pickaxe", True),
])
def test_minerl_matches_jax(sims, env_id, multihot):
    jax_mod, port_mod = _pair("minerl")
    kwargs = dict(height=64, width=64, pitch_limits=(-60, 60), sticky_attack=30, sticky_jump=10,
                  break_speed_multiplier=100, multihot_inventory=multihot, dense=True, extreme=False)
    _fresh_seeds(sims, "minerl")
    jax_env = jax_mod.MineRLWrapper(env_id, **kwargs)
    _fresh_seeds(sims, "minerl")
    port_env = port_mod.MineRLWrapper(env_id, **kwargs)
    assert port_env.ACTIONS_MAP.keys() == jax_env.ACTIONS_MAP.keys()
    _same({k: {a: np.asarray(v) for a, v in e.items()} for k, e in jax_env.ACTIONS_MAP.items()},
          {k: {a: np.asarray(v) for a, v in e.items()} for k, e in port_env.ACTIONS_MAP.items()}, "ACTIONS_MAP")
    assert port_env.observation_space["rgb"].shape == (3, 64, 64)  # channel-first, as make_env expects
    assert ("equipment" in port_env.observation_space) == ("obtain" in env_id)
    assert ("compass" in port_env.observation_space) == ("navigate" in env_id)
    steps = _run_pair(jax_env, port_env, _minerl_script(port_env, 90, np.random.default_rng(2)))
    assert len(steps) == 90
    jax_sent, port_sent = _received(jax_env), _received(port_env)
    _same(jax_sent, port_sent, "received")
    # the branches ran: the pitch held at -60 (camera zeroed), sticky attack and sticky jump after their no-ops
    assert any(np.array_equal(np.asarray(a["camera"]), [0, 0]) for a in port_sent[4:6])
    assert all(a["attack"] == 1 and a["jump"] == 0 for a in port_sent[20:25])
    assert all(a["jump"] == 1 and a["forward"] == 1 for a in port_sent[32:36])
    assert port_env._max_inventory is not jax_env._max_inventory
    _same(jax_env.render(), port_env.render(), "render")


# ---------------------------------------------------------------------------
# MineDojo
# ---------------------------------------------------------------------------


def _minedojo_action(rng, want=None):
    """An action valid under the observation's masks: ``want`` (an action type) where it is valid, else a random
    valid type; the craft argument among the valid crafts, the item among the equip/place or destroy masks."""

    def pick(obs):
        types_ok = np.flatnonzero(obs["mask_action_type"])
        kind = want if want is not None and obs["mask_action_type"][want] else int(rng.choice(types_ok))
        craft_ok = np.flatnonzero(obs["mask_craft_smelt"])
        craft = int(rng.choice(craft_ok)) if craft_ok.size else 0
        items = np.flatnonzero(obs["mask_destroy"] if kind == 18 else obs["mask_equip_place"])
        item = int(rng.choice(items)) if items.size and kind in (16, 17, 18) else 0
        return np.array([kind, craft, item])

    return pick


def _minedojo_script(rng, n):
    # attack then no-ops (sticky attack), a use turning sticky attack off for good (the JAX package's :204-205),
    # another attack then no-ops (no longer sticky); jump then no-ops (sticky jump), jump then a move (the counter
    # reset); pitch up past the limit; the functional actions where the masks allow them; then random valid actions
    head = [14, 0, 0, 12, 14, 0, 5, 0, 0, 5, 1, 9, 9, 9, 9, 9, 9, 8, 15, 16, 17, 18, 15, 16, 17, 18]
    return [_minedojo_action(rng, a) for a in head] + [_minedojo_action(rng) for _ in range(n - len(head))]


def test_minedojo_matches_jax(sims):
    jax_mod, port_mod = _pair("minedojo")
    kwargs = dict(height=64, width=64, pitch_limits=(-60, 60), seed=None, sticky_attack=30, sticky_jump=10,
                  break_speed_multiplier=100, start_position=None)
    _fresh_seeds(sims, "minedojo")
    jax_env = jax_mod.MineDojoWrapper("open-ended", **kwargs)
    _fresh_seeds(sims, "minedojo")
    port_env = port_mod.MineDojoWrapper("open-ended", **kwargs)
    assert port_env.observation_space["rgb"].shape == (3, 64, 64)
    rng = np.random.default_rng(3)
    steps = _run_pair(jax_env, port_env, _minedojo_script(rng, 110))
    jax_sent, port_sent = _received(jax_env), _received(port_env)
    _same(jax_sent, port_sent, "received")
    fn = np.array([a[5] for a in port_sent])
    # sticky attack: the no-ops after the first attack attack; the use at step 3 turns it off for good, so the no-op
    # after the second attack is a no-op, and so are those of every later episode
    assert fn[0] == 3 and fn[1] == 3 and fn[2] == 3 and fn[3] == 1 and fn[4] == 3 and fn[5] == 0
    assert port_env._sticky_attack == jax_env._sticky_attack == 0
    assert port_sent[7][2] == 1 and port_sent[7][0] == 1  # sticky jump moves forward on a no-op
    assert port_sent[10][2] == 0  # a move resets the jump counter
    pitches = [s[1][4]["location_stats"]["pitch"] for s in steps]
    assert max(pitches) <= 60.0 and port_sent[15][3] == port_sent[16][3] == 12  # +15 past 60 clamped
    # the masks' branches: functional actions forbidden and allowed, an empty-handed inventory
    masks = [s[1][0]["mask_action_type"] for s in steps]
    assert any(not m[16] for m in masks) and any(m[16] for m in masks)
    assert any(not m[18] for m in masks) and any(m[18] for m in masks) and any(not m[15] for m in masks)
    assert {4, 5, 6, 7} <= set(fn.tolist())
    assert jax_env.env.invalid == port_env.env.invalid == []  # every scripted action valid under its masks
    _same(jax_env.render(), port_env.render(), "render")
    start = dict(kwargs, start_position={"x": 0, "y": 0, "z": 0, "pitch": 75, "yaw": 0})
    for mod in (jax_mod, port_mod):
        with pytest.raises(ValueError, match="pitch limits"):
            mod.MineDojoWrapper("open-ended", **start)


def test_the_minedojo_stand_in_flags_an_action_its_masks_forbid(sims):
    """The MineDojo stand-in takes an action its masks forbid (a craft of an item that cannot be crafted, or a
    craft at all when nothing can be) and flags it in ``invalid`` without raising; a no-op is not flagged."""
    env = sims["minedojo"].make("open-ended", image_size=(64, 64), world_seed=0)
    masks = env.reset()["masks"]
    item = int(np.flatnonzero(~masks["craft_smelt"])[0])
    env.step(np.array([0, 0, 0, 12, 12, 4, item, 0]))
    env.step(np.array([0, 0, 0, 12, 12, 0, 0, 0]))
    assert len(env.received) == 2 and [i for i, _reason in env.invalid] == [0]
    assert env.invalid[0][1] in ("functional action 4", f"craft of item {item}")


def test_an_equip_of_an_item_not_in_the_inventory_raises_in_both_wrappers(sims):
    """The wrappers look the item of an equip, place or destroy up in the inventory they hold
    (``sheeprl_tpu/envs/minedojo.py:218``, as upstream SheepRL's): an item that is not there raises KeyError in
    both, before the simulator sees the action. So an action drawn without the masks (a random prefill, an unmasked
    test episode) can crash a MineDojo env, which the env's restart wrapper then rebuilds."""
    wrappers = []
    for module in _pair("minedojo"):
        _fresh_seeds(sims, "minedojo")
        env = module.MineDojoWrapper("open-ended", height=64, width=64, pitch_limits=(-60, 60), seed=None,
                                     sticky_attack=0, sticky_jump=0)
        obs, _ = env.reset(seed=0)
        wrappers.append((env, obs))
    (jax_env, jax_obs), (port_env, port_obs) = wrappers
    _same(jax_obs, port_obs, "reset")
    absent = int(np.flatnonzero(port_obs["inventory"] == 0)[0])  # an item the inventory does not hold
    for env in (jax_env, port_env):
        with pytest.raises(KeyError):
            env.step(np.array([16, 0, absent]))
        assert env.env.received == []

"""Stand-in simulator packages: ``crafter``, ``diambra`` (with
``diambra.arena``), ``minerl`` (with the ``minerl.herobraine`` names the
MineRL wrapper and its env specs import) and ``minedojo`` (with
``minedojo.sim``), for machines that have none of the simulators.

:func:`install` puts them into ``sys.modules``, each with a ``__spec__``, so
that the import probes (:mod:`sheeprl_tpu_torch.utils.imports`) find them
and the real-simulator wrappers import and run over them; :func:`uninstall`
takes them out again. They import neither torch nor JAX. Their spaces are
duck-typed ones with gymnasium's attributes (``low``, ``high``, ``shape``,
``dtype``, ``n``, ``nvec``, ``start``, ``spaces``), or gymnasium's own (as
the real packages hand out) with ``gymnasium=True``.

Every stub env draws seeded observations in its spaces (numpy), ends an
episode every :data:`EPISODE_STEPS` steps and records every action it
receives in ``received``. It raises on an action outside its action space
(a discrete action out of range, a MineRL action key of the wrong value).
The MineDojo env also flags, without raising, every action that the masks
it handed out with the previous observation forbid: ``invalid`` holds the
index in ``received`` and the reason of each. An env made without a seed
takes the next of its module's ``next_seed`` (reset by :func:`install`).
The tests and ``chip_smoke.py`` use them:

    import sim_stubs  # tests/ on sys.path
    sim_stubs.install("crafter", "diambra", "minerl", "minedojo")
"""

from __future__ import annotations

import importlib
import importlib.machinery
import itertools
import sys
import types
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["EPISODE_STEPS", "SIMULATORS", "install", "installed", "uninstall"]

# an episode (a Crafter life, a DIAMBRA round, a Minecraft episode) ends after this many steps
EPISODE_STEPS = 32
# Crafter's 17 actions
CRAFTER_ACTIONS = 17
# DIAMBRA's Dead or Alive++ with the env config's flattened, role-relative wrappers: each key's raw space,
# ("box", low, high) of shape (1,) int32 or ("discrete", n); the legacy P1_* names too. 11 characters; 16
# combo-discrete actions (9 moves + 8 attack-button combinations - 1 shared no-op), also the last action's key;
# the multi-discrete action space is the moves and the attack buttons
DOAPP_ACTIONS = 16
DOAPP_MULTI_ACTIONS = (9, 8)
DOAPP_NATIVE_FRAME = (480, 512, 3)
DOAPP_RAW_KEYS = {
    **{f"{side}_{k}": v for side in ("own", "opp") for k, v in (
        ("character", ("discrete", 11)), ("health", ("box", 0, 208)), ("side", ("discrete", 2)),
        ("wins", ("box", 0, 2)))},
    "stage": ("box", 1, 8), "timer": ("box", 0, 40), "action": ("discrete", DOAPP_ACTIONS),
    **{f"P1_{side}{k}": v for side in ("own", "opp") for k, v in (
        ("Char", ("discrete", 11)), ("Health", ("box", 0, 208)), ("Side", ("discrete", 2)), ("Wins", ("box", 0, 2)))},
    "P1_actions_move": ("discrete", 9), "P1_actions_attack": ("discrete", 8),
}
# Minecraft items (MineRL's mc.ALL_ITEMS and MineDojo's ALL_ITEMS share the names): air first, then the blocks and
# items the custom tasks name, then more of the game's, so that a multi-hot inventory is wider than any one task's
MC_ITEMS = (
    "air", "dirt", "stone", "cobblestone", "log", "planks", "stick", "crafting_table", "wooden_axe",
    "wooden_pickaxe", "stone_axe", "stone_pickaxe", "iron_ore", "iron_ingot", "iron_axe", "iron_pickaxe",
    "coal", "torch", "furnace", "diamond", "diamond_block", "compass", "sand", "gravel", "sapling", "leaves",
    "wheat_seeds", "apple", "bread", "wool", "bed", "bucket", "water_bucket", "shears", "diamond_sword",
    "iron_sword", "stone_sword", "wooden_sword", "gold_ingot", "redstone", "glass", "ladder", "chest",
    "fence", "boat", "bone", "string", "feather", "gunpowder", "leather", "egg", "sugar_cane", "paper",
    "book", "bowl", "mushroom_stew", "cactus", "pumpkin", "snowball", "clay_ball",
)
# MineDojo's craft/smelt targets, a slice of the items
MINEDOJO_CRAFT_SMELT = MC_ITEMS[4:20]
MINEDOJO_SLOTS = 36
MINEDOJO_EQUIPPABLE = frozenset(MC_ITEMS[1:20]) - {"coal", "stick"}
MINEDOJO_DESTROYABLE = frozenset(MC_ITEMS[1:8])
# the MineRL keyboard map (minerl.herobraine.hero.mc.INVERSE_KEYMAP)
INVERSE_KEYMAP = {
    "forward": "key.keyboard.w", "back": "key.keyboard.s", "left": "key.keyboard.a", "right": "key.keyboard.d",
    "jump": "key.keyboard.space", "sneak": "key.keyboard.left.shift", "sprint": "key.keyboard.left.control",
    "attack": "key.mouse.left", "use": "key.mouse.right", "drop": "key.keyboard.q", "inventory": "key.keyboard.e",
}
MS_PER_STEP = 50
SIMULATORS = ("crafter", "diambra", "minerl", "minedojo")
_MODULES = {
    "crafter": ("crafter",),
    "diambra": ("diambra", "diambra.arena"),
    "minerl": ("minerl", "minerl.herobraine", "minerl.herobraine.env_spec", "minerl.herobraine.hero",
               "minerl.herobraine.hero.handler", "minerl.herobraine.hero.handlers",
               "minerl.herobraine.hero.handlers.translation", "minerl.herobraine.hero.mc",
               "minerl.herobraine.hero.spaces"),
    "minedojo": ("minedojo", "minedojo.sim"),
}


# ---------------------------------------------------------------------------
# spaces
# ---------------------------------------------------------------------------


class _DuckSpace:
    def seed(self, seed=None):
        self.np_random = np.random.default_rng(seed)
        return [seed]


class Box(_DuckSpace):
    def __init__(self, low, high, shape=None, dtype=np.float32):
        shape = np.broadcast(np.asarray(low), np.asarray(high)).shape if shape is None else tuple(shape)
        self.shape, self.dtype = tuple(int(s) for s in shape), np.dtype(dtype)
        self.low = np.broadcast_to(np.asarray(low, dtype=self.dtype), self.shape).copy()
        self.high = np.broadcast_to(np.asarray(high, dtype=self.dtype), self.shape).copy()


class Discrete(_DuckSpace):
    def __init__(self, n, start=0):
        self.n, self.start, self.shape, self.dtype = int(n), int(start), (), np.dtype(np.int64)


class MultiDiscrete(_DuckSpace):
    def __init__(self, nvec):
        self.nvec = np.asarray(nvec, dtype=np.int64)
        self.start, self.shape, self.dtype = np.zeros_like(self.nvec), self.nvec.shape, np.dtype(np.int64)


class Dict(_DuckSpace):
    def __init__(self, spaces):
        self.spaces = dict(spaces)

    def __getitem__(self, key):
        return self.spaces[key]

    def __iter__(self):
        return iter(self.spaces)

    def __contains__(self, key):
        return key in self.spaces

    def keys(self):
        return self.spaces.keys()

    def items(self):
        return self.spaces.items()


def _kit(gymnasium: bool):
    """(the spaces namespace, the env base class): gymnasium's, or the duck-typed ones."""
    if gymnasium:
        import gymnasium as gym

        return gym.spaces, gym.Env
    return types.SimpleNamespace(Box=Box, Discrete=Discrete, MultiDiscrete=MultiDiscrete, Dict=Dict), object


def _sorted_dict(sp, items: Dict[str, Any]):
    # gymnasium sorts a plain mapping's keys; the duck Dict keeps them in the same order
    return sp.Dict(dict(sorted(items.items())))


def _draw(space, rng: np.random.Generator):
    """A seeded value inside ``space`` (a Box's integer or uint8 values, a float Box's uniform or normal ones)."""
    kind = type(space).__name__
    if kind == "Discrete":
        return int(rng.integers(space.n))
    if kind == "MultiDiscrete":
        return rng.integers(0, space.nvec).astype(np.int64)
    low, high, dtype = np.asarray(space.low), np.asarray(space.high), np.dtype(space.dtype)
    if dtype.kind in "iub":
        return rng.integers(low.astype(np.int64), high.astype(np.int64), endpoint=True).astype(dtype)
    finite = np.isfinite(low) & np.isfinite(high)
    out = np.where(finite, rng.uniform(np.where(finite, low, 0.0), np.where(finite, high, 1.0)),
                   rng.normal(size=space.shape))
    return out.astype(dtype)


def _new_module(name: str, doc: str) -> types.ModuleType:
    module = types.ModuleType(name, doc)
    module.__spec__ = importlib.machinery.ModuleSpec(name, loader=None, is_package=True)
    module.__path__ = []
    return module


# ---------------------------------------------------------------------------
# crafter
# ---------------------------------------------------------------------------


def _crafter(sp, base) -> Dict[str, types.ModuleType]:
    crafter = _new_module("crafter", "Stand-in of the crafter package (tests/sim_stubs.py).")
    crafter.next_seed = itertools.count()

    class Env(base):
        """``crafter.Env``: an ``(H, W, 3)`` uint8 frame, 17 actions, the old four-tuple ``step``."""

        def __init__(self, area=(64, 64), view=(9, 9), size=(64, 64), reward=True, length=10000, seed=None):
            self.size, self.reward = tuple(size), bool(reward)
            self.observation_space = sp.Box(0, 255, self.size + (3,), np.uint8)
            self.action_space = sp.Discrete(CRAFTER_ACTIONS)
            self.reward_range = None
            self.seed_given = seed
            self._rng = np.random.default_rng(next(crafter.next_seed) if seed is None else seed)
            self._t, self._frame, self.received = 0, None, []

        def reset(self):
            self._t = 0
            self._frame = _draw(self.observation_space, self._rng)
            return self._frame

        def step(self, action):
            self.received.append(action)
            a = np.asarray(action)
            if a.size != 1 or not 0 <= int(a.reshape(())) < CRAFTER_ACTIONS:
                raise ValueError(f"crafter got an action outside Discrete({CRAFTER_ACTIONS}): {action}")
            self._t += 1
            self._frame = _draw(self.observation_space, self._rng)
            reward = float(self._rng.integers(-1, 2)) if self.reward else 0.0
            return self._frame, reward, self._t >= EPISODE_STEPS, {"discount": 1.0, "semantic": None}

        def render(self, size=None):
            return self._frame

    crafter.Env = Env
    return {"crafter": crafter}


# ---------------------------------------------------------------------------
# diambra
# ---------------------------------------------------------------------------


def _diambra(sp, base) -> Dict[str, types.ModuleType]:
    diambra = _new_module("diambra", "Stand-in of the diambra package (tests/sim_stubs.py).")
    arena = _new_module("diambra.arena", "Stand-in of diambra.arena (tests/sim_stubs.py).")

    class SpaceTypes:
        DISCRETE, MULTI_DISCRETE = 0, 1

    class Roles:
        P1, P2 = 0, 1

    class _Settings:
        """Keyword settings kept as attributes (the engine's dataclasses)."""

        def __init__(self, **kwargs):
            self.__dict__.update(kwargs)

        def as_dict(self) -> Dict[str, Any]:
            return dict(self.__dict__)

    class EnvironmentSettings(_Settings):
        def __init__(self, **kwargs):
            kwargs.setdefault("step_ratio", 6)
            kwargs.setdefault("frame_shape", (0, 0, 0))
            super().__init__(**kwargs)

    class WrappersSettings(_Settings):
        def __init__(self, **kwargs):
            kwargs.setdefault("frame_shape", (0, 0, 0))
            super().__init__(**kwargs)

    def _frame_shape(settings, wrappers) -> Tuple[int, int, int]:
        # the engine's resize, else the wrapper's, else the native frame; a third value of 1 is grey, 0 keeps RGB
        for shape in (wrappers.frame_shape, settings.frame_shape):
            h, w, c = (int(v) for v in shape)
            if h and w:
                return h, w, 1 if c == 1 else 3
        return DOAPP_NATIVE_FRAME

    class Env(base):
        """``diambra.arena.make``'s env: Dead or Alive++'s flattened observation keys and the frame."""

        def __init__(self, game_id, settings, wrappers, rank=0, render_mode=None, log_level=0):
            self.game_id, self.settings, self.wrappers, self.rank = game_id, settings, wrappers, rank
            self.render_mode, self.log_level = render_mode, log_level
            raw = {"frame": sp.Box(0, 255, _frame_shape(settings, wrappers), np.uint8)}
            for k, (kind, *args) in DOAPP_RAW_KEYS.items():
                raw[k] = sp.Discrete(args[0]) if kind == "discrete" else sp.Box(args[0], args[1], (1,), np.int32)
            self.observation_space = _sorted_dict(sp, raw)
            self.discrete = settings.action_space == SpaceTypes.DISCRETE
            self.action_space = sp.Discrete(DOAPP_ACTIONS) if self.discrete else sp.MultiDiscrete(DOAPP_MULTI_ACTIONS)
            self._rng = np.random.default_rng(rank)
            self._t, self._obs, self.received = 0, None, []

        def _draw(self):
            self._obs = {k: _draw(s, self._rng) for k, s in self.observation_space.spaces.items()}
            return self._obs

        def reset(self, seed=None, options=None):
            if seed is not None:
                self._rng = np.random.default_rng(seed)
            self._t = 0
            return self._draw(), {"round_done": False, "stage_done": False, "game_done": False, "env_done": False}

        def step(self, action):
            self.received.append(action)
            a = np.asarray(action)
            if self.discrete:
                ok = a.size == 1 and 0 <= int(a.reshape(())) < DOAPP_ACTIONS
            else:
                ok = a.shape == (len(DOAPP_MULTI_ACTIONS),) and bool(np.all((a >= 0) & (a < DOAPP_MULTI_ACTIONS)))
            if not ok:
                raise ValueError(f"diambra got an action outside its action space: {action}")
            self._t += 1
            done = self._t >= EPISODE_STEPS
            info = {"round_done": done, "stage_done": False, "game_done": done, "env_done": done}
            return self._draw(), float(self._rng.integers(-10, 11)), False, False, info

        def render(self):
            return self._obs["frame"] if self._obs is not None else None

        def close(self):
            return None

    def make(game_id, settings=None, wrappers=None, rank=0, render_mode=None, log_level=0):
        return Env(game_id, settings or EnvironmentSettings(), wrappers or WrappersSettings(), rank, render_mode,
                   log_level)

    arena.SpaceTypes, arena.Roles = SpaceTypes, Roles
    arena.EnvironmentSettings, arena.WrappersSettings, arena.make = EnvironmentSettings, WrappersSettings, make
    diambra.arena = arena
    return {"diambra": diambra, "diambra.arena": arena}


# ---------------------------------------------------------------------------
# minerl
# ---------------------------------------------------------------------------


def _minerl(sp, base) -> Dict[str, types.ModuleType]:
    names = _MODULES["minerl"]
    mods = {n: _new_module(n, f"Stand-in of {n} (tests/sim_stubs.py).") for n in names}
    minerl = mods["minerl"]
    minerl.next_seed = itertools.count()
    hero = mods["minerl.herobraine.hero"]
    handler_mod, handlers = mods["minerl.herobraine.hero.handler"], mods["minerl.herobraine.hero.handlers"]

    class Enum(sp.Discrete):
        """``minerl.herobraine.hero.spaces.Enum``: named values, a ``default``."""

        def __init__(self, *values, default=None):
            super().__init__(len(values))
            self.values = np.array(values)
            self.default = values[0] if default is None else default

    class Handler:
        """A herobraine handler: its class name and arguments (``describe``) and the space it adds."""

        def __init__(self, *args, **kwargs):
            self.args, self.kwargs = args, kwargs

        def describe(self) -> Tuple[str, tuple, Dict[str, Any]]:
            # a subclass that keeps its own attributes (BreakSpeedMultiplier) is described by them
            if "args" not in vars(self):
                return type(self).__name__, (), dict(vars(self))
            return type(self).__name__, self.args, self.kwargs

        def to_string(self):
            return type(self).__name__

        def xml_template(self):
            return ""

    class TranslationHandler(Handler):
        key: Optional[str] = None

        def space(self):
            return None

    def _handler(name: str, key: Optional[str] = None, space=None):
        cls = type(name, (TranslationHandler,), {"key": key})
        if space is not None:
            cls.space = lambda self, _f=space: _f(*self.args, **self.kwargs)
        setattr(handlers, name, cls)
        return cls

    def _items_enum(items, _other="none", _default="none", **_):
        return Enum(*items, default=_default)

    _handler("POVObservation", "pov", lambda resolution, *a, **k: sp.Box(0, 255, tuple(resolution) + (3,), np.uint8))
    _handler("ObservationFromCurrentLocation", "location_stats", lambda *a, **k: _sorted_dict(sp, {
        n: sp.Box(-640000.0, 640000.0, (), np.float32) for n in ("xpos", "ypos", "zpos", "pitch", "yaw")}))
    _handler("ObservationFromLifeStats", "life_stats", lambda *a, **k: _sorted_dict(sp, {
        "life": sp.Box(0.0, 20.0, (), np.float32), "food": sp.Box(0.0, 20.0, (), np.float32),
        "air": sp.Box(0.0, 300.0, (), np.float32)}))
    _handler("CompassObservation", "compass", lambda *a, **k: _sorted_dict(sp, {
        "angle": sp.Box(-180.0, 180.0, (), np.float32)}))
    _handler("FlatInventoryObservation", "inventory", lambda items, *a, **k: _sorted_dict(sp, {
        i: sp.Box(0, 2304, (), np.int64) for i in items}))
    _handler("EquippedItemObservation", "equipped_items", lambda items, *a, **k: _sorted_dict(sp, {
        "mainhand": _sorted_dict(sp, {"type": _items_enum(items, **k)})}))
    _handler("KeybasedCommandAction", None, lambda command, *a, **k: sp.Discrete(2))
    _handler("CameraAction", "camera", lambda *a, **k: sp.Box(-180.0, 180.0, (2,), np.float32))
    for name, key in (("PlaceBlock", "place"), ("EquipAction", "equip"), ("CraftAction", "craft"),
                      ("CraftNearbyAction", "nearbyCraft"), ("SmeltItemNearby", "nearbySmelt")):
        _handler(name, key, _items_enum)
    for name in ("RewardForTouchingBlockType", "RewardForDistanceTraveledToCompassTarget", "SimpleInventoryAgentStart",
                 "AgentQuitFromTouchingBlockType", "BiomeGenerator", "DefaultWorldGenerator", "ServerQuitFromTimeUp",
                 "ServerQuitWhenAnyAgentFinishes", "NavigationDecorator", "TimeInitialCondition",
                 "WeatherInitialCondition", "SpawningInitialCondition", "RewardForCollectingItems",
                 "RewardForCollectingItemsOnce", "AgentQuitFromPossessingItem"):
        _handler(name)

    def _key(h) -> Optional[str]:
        return h.args[0] if type(h).__name__ == "KeybasedCommandAction" else h.key

    class EnvSpec:
        """``minerl.herobraine.env_spec.EnvSpec``: the handler lists, the spaces they make, ``make()``."""

        def __init__(self, name, max_episode_steps=None, reward_threshold=None):
            self.name, self.max_episode_steps, self.reward_threshold = name, max_episode_steps, reward_threshold
            self.reset()

        def reset(self):
            self.observables = self.create_observables()
            self.actionables = self.create_actionables()
            self.rewardables = self.create_rewardables()
            self.agent_handlers = self.create_agent_handlers()
            self.agent_start = self.create_agent_start()
            self.monitors = self.create_monitors()
            self.server_world_generators = self.create_server_world_generators()
            self.server_quit_producers = self.create_server_quit_producers()
            self.server_decorators = self.create_server_decorators()
            self.server_initial_conditions = self.create_server_initial_conditions()
            self.observation_space = _sorted_dict(sp, {_key(h): h.space() for h in self.observables if _key(h)})
            self.action_space = _sorted_dict(sp, {_key(h): h.space() for h in self.actionables})

        def handler_lists(self) -> Dict[str, List[Tuple[str, tuple, Dict[str, Any]]]]:
            lists = ("observables", "actionables", "rewardables", "agent_handlers", "agent_start", "monitors",
                     "server_world_generators", "server_quit_producers", "server_decorators",
                     "server_initial_conditions")
            return {n: [h.describe() for h in getattr(self, n)] for n in lists}

        def create_monitors(self):
            return []

        def make(self):
            return MineRLEnv(self, next(minerl.next_seed))

    class MineRLEnv(base):
        """A MineRL env: dict observations and dict actions, the old four-tuple ``step``."""

        def __init__(self, spec, seed):
            self.spec_ = spec
            self.observation_space, self.action_space = spec.observation_space, spec.action_space
            self._rng = np.random.default_rng(seed)
            self._t, self._obs, self.received = 0, None, []

        def _draw(self):
            obs = {}
            for key, space in self.observation_space.spaces.items():
                if key == "equipped_items":
                    enum = space["mainhand"]["type"]
                    obs[key] = {"mainhand": {"type": str(enum.values[self._rng.integers(enum.n)])}}
                elif type(space).__name__ == "Dict":
                    obs[key] = {k: _draw(s, self._rng) for k, s in space.spaces.items()}
                else:
                    obs[key] = _draw(space, self._rng)
            self._obs = obs
            return obs

        def reset(self):
            self._t = 0
            return self._draw()

        def _check(self, action: Dict[str, Any]) -> None:
            for key, value in action.items():
                space = self.action_space.spaces.get(key)
                if space is None:
                    if value not in (0, "none") and not (key == "camera" and np.all(np.asarray(value) == 0)):
                        raise ValueError(f"minerl got {key}={value!r}, which this task has no handler for")
                elif isinstance(space, Enum):
                    if value not in space.values.tolist():
                        raise ValueError(f"minerl got {key}={value!r}, not one of {space.values.tolist()}")
                elif type(space).__name__ == "Box":
                    v = np.asarray(value, dtype=np.float64)
                    if v.shape != space.shape or np.any(np.abs(v) > 180.0):
                        raise ValueError(f"minerl got camera {value!r}")
                elif value not in (0, 1):
                    raise ValueError(f"minerl got {key}={value!r}, not a key state")

        def step(self, action: Dict[str, Any]):
            self.received.append(action)
            self._check(action)
            self._t += 1
            reward = float(self._rng.integers(0, 2))
            return self._draw(), reward, self._t >= EPISODE_STEPS, {}

        def render(self, mode="rgb_array"):
            return None if self._obs is None else self._obs["pov"]

        def close(self):
            return None

    mods["minerl.herobraine.hero.spaces"].Enum = Enum
    handler_mod.Handler = Handler
    mods["minerl.herobraine.hero.handlers.translation"].TranslationHandler = TranslationHandler
    handlers.translation = mods["minerl.herobraine.hero.handlers.translation"]
    mc = mods["minerl.herobraine.hero.mc"]
    mc.ALL_ITEMS, mc.INVERSE_KEYMAP, mc.MS_PER_STEP = list(MC_ITEMS), dict(INVERSE_KEYMAP), MS_PER_STEP
    mods["minerl.herobraine.env_spec"].EnvSpec = EnvSpec
    hero.handler, hero.handlers, hero.mc, hero.spaces = handler_mod, handlers, mc, mods["minerl.herobraine.hero.spaces"]
    mods["minerl.herobraine"].hero, mods["minerl.herobraine"].env_spec = hero, mods["minerl.herobraine.env_spec"]
    minerl.herobraine = mods["minerl.herobraine"]
    return mods


# ---------------------------------------------------------------------------
# minedojo
# ---------------------------------------------------------------------------


def _minedojo(sp, base) -> Dict[str, types.ModuleType]:
    minedojo = _new_module("minedojo", "Stand-in of the minedojo package (tests/sim_stubs.py).")
    sim = _new_module("minedojo.sim", "Stand-in of minedojo.sim (tests/sim_stubs.py).")
    sim.ALL_ITEMS, sim.ALL_CRAFT_SMELT_ITEMS = list(MC_ITEMS), list(MINEDOJO_CRAFT_SMELT)
    minedojo.sim, minedojo.next_seed = sim, itertools.count()

    def _shown(item: str) -> str:
        return item.replace("_", " ")  # the simulator names items with spaces

    class MineDojoEnv(base):
        """``minedojo.make``'s env: the 8-entry action, the inventory, masks and stats dicts."""

        def __init__(self, task_id, image_size, world_seed=None, start_position=None, **kwargs):
            self.task_id, self.kwargs = task_id, dict(kwargs, start_position=start_position)
            h, w = (image_size, image_size) if isinstance(image_size, int) else tuple(image_size)
            self.observation_space = _sorted_dict(sp, {"rgb": sp.Box(0, 255, (3, h, w), np.uint8)})
            self.action_space = sp.MultiDiscrete([3, 3, 4, 25, 25, 8, 244, MINEDOJO_SLOTS])
            self._rng = np.random.default_rng(next(minedojo.next_seed) if world_seed is None else world_seed)
            self._start = dict(start_position) if start_position else {"pitch": 0.0, "yaw": 0.0}
            self._t, self._prev_obs, self._masks, self.received, self.invalid = 0, None, None, [], []

        @property
        def unwrapped(self):
            return self

        def _inventory(self):
            # an empty-handed inventory now and then: no item to equip, place or destroy
            pool = MC_ITEMS[1:8] if self._rng.random() < 0.25 else MC_ITEMS[1:24]
            if self._rng.random() < 0.2:
                pool = ("coal", "stick", "apple")
            names = np.array(["air"] * MINEDOJO_SLOTS, dtype=object)
            filled = self._rng.choice(MINEDOJO_SLOTS, int(self._rng.integers(1, 12)), replace=False)
            names[filled] = self._rng.choice(np.array(pool, dtype=object), filled.size)
            quantity = np.where(names == "air", 0, self._rng.integers(1, 65, MINEDOJO_SLOTS)).astype(np.float32)
            return names, quantity

        def _draw(self):
            names, quantity = self._inventory()
            equip = np.array([n in MINEDOJO_EQUIPPABLE for n in names])
            destroy = np.array([n in MINEDOJO_DESTROYABLE for n in names])
            # now and then nothing to craft or smelt
            craft = self._rng.random(len(MINEDOJO_CRAFT_SMELT)) < (0.0 if self._rng.random() < 0.2 else 0.3)
            # no-op, use, drop, attack always; craft, equip, place, destroy as the inventory allows
            action_type = np.array([True, True, True, True, craft.any(), True, True, self._rng.random() < 0.7])
            delta = {}
            for way in ("craft", "other"):
                for sign in ("inc", "dec"):
                    k = int(self._rng.integers(0, 3))
                    delta[f"{sign}_name_by_{way}"] = np.array(
                        [_shown(MC_ITEMS[i]) for i in self._rng.integers(1, len(MC_ITEMS), k)], dtype=object)
                    delta[f"{sign}_quantity_by_{way}"] = self._rng.integers(1, 5, k).astype(np.float32)
            obs = {
                "rgb": _draw(self.observation_space["rgb"], self._rng),
                "inventory": {"name": np.array([_shown(n) for n in names], dtype=object), "quantity": quantity},
                "delta_inv": delta,
                "equipment": {"name": np.array([_shown(str(names[0])), "air", "air", "air", "air", "air"],
                                               dtype=object)},
                "life_stats": {"life": np.array([self._rng.uniform(0, 20)], np.float32),
                               "food": np.array([self._rng.uniform(0, 20)], np.float32),
                               "oxygen": np.array([self._rng.uniform(0, 300)], np.float32)},
                "masks": {"action_type": action_type, "equip": equip, "destroy": destroy, "craft_smelt": craft},
                "location_stats": {"pos": self._rng.normal(size=3).astype(np.float32),
                                   "pitch": np.array([self._pitch], np.float32),
                                   "yaw": np.array([self._yaw], np.float32),
                                   "biome_id": np.array([float(self._rng.integers(0, 40))], np.float32)},
            }
            # the masks as handed out: the wrapper may narrow them in place, which is what the agent sees
            self._masks = obs["masks"]
            self._prev_obs = obs
            return obs

        def reset(self):
            self._t = 0
            self._pitch, self._yaw = float(self._start["pitch"]), float(self._start["yaw"])
            return self._draw()

        def _forbidden(self, action) -> Optional[str]:
            """Why the masks handed out with the last observation forbid ``action``, or None."""
            a = np.asarray(action)
            if a.shape != (8,) or np.any(a < 0) or np.any(a >= self.action_space.nvec):
                raise ValueError(f"minedojo got an action outside its action space: {action}")
            fn, masks = int(a[5]), self._masks
            if not masks["action_type"][fn]:
                return f"functional action {fn}"
            if fn == 4 and not masks["craft_smelt"][a[6]]:
                return f"craft of item {a[6]}"
            if fn in (5, 6) and not masks["equip"][a[7]]:
                return f"equip/place of slot {a[7]}"
            if fn == 7 and not masks["destroy"][a[7]]:
                return f"destroy of slot {a[7]}"
            return None

        def step(self, action):
            self.received.append(np.array(action, copy=True))
            reason = self._forbidden(action)
            if reason is not None:
                self.invalid.append((len(self.received) - 1, reason))
            self._t += 1
            self._pitch += (int(action[3]) - 12) * 15.0
            self._yaw = ((self._yaw + (int(action[4]) - 12) * 15.0) + 180.0) % 360.0 - 180.0
            return self._draw(), float(self._rng.integers(0, 2)), self._t >= EPISODE_STEPS, {}

        def render(self):
            return None if self._prev_obs is None else self._prev_obs["rgb"]

        def close(self):
            return None

    def make(task_id, image_size=(64, 64), world_seed=None, **kwargs):
        return MineDojoEnv(task_id, image_size, world_seed, **kwargs)

    minedojo.make = make
    return {"minedojo": minedojo, "minedojo.sim": sim}


_BUILDERS = {"crafter": _crafter, "diambra": _diambra, "minerl": _minerl, "minedojo": _minedojo}


def install(*simulators: str, gymnasium: bool = False) -> Dict[str, types.ModuleType]:
    """Put the stand-ins of ``simulators`` (default: all four) into
    ``sys.modules`` and reload the port's import probes if they are loaded.
    Their spaces are duck-typed, or gymnasium's with ``gymnasium=True``.
    Returns the modules by name."""
    sp, base = _kit(gymnasium)
    out = {}
    for name in simulators or SIMULATORS:
        out.update(_BUILDERS[name](sp, base))
    sys.modules.update(out)
    probes = sys.modules.get("sheeprl_tpu_torch.utils.imports")
    if probes is not None:
        importlib.reload(probes)
    return out


def installed(simulator: str) -> bool:
    """Whether ``simulator``'s stand-in is the module in ``sys.modules``."""
    module = sys.modules.get(simulator)
    return module is not None and "sim_stubs" in (module.__doc__ or "")


def uninstall(*simulators: str) -> None:
    """Take the stand-ins of ``simulators`` (default: all four) out of
    ``sys.modules``, with the port's wrapper modules imported over them, and
    reload the port's probes."""
    wrappers = {"crafter": ("crafter",), "diambra": ("diambra",), "minedojo": ("minedojo",),
                "minerl": ("minerl", "minerl_envs")}
    for name in simulators or SIMULATORS:
        if installed(name):
            for module in _MODULES[name]:
                sys.modules.pop(module, None)
        for stem in wrappers[name]:
            prefix = "sheeprl_tpu_torch.envs." + stem
            for module in [m for m in sys.modules if m == prefix or m.startswith(prefix + ".")]:
                sys.modules.pop(module, None)
    probes = sys.modules.get("sheeprl_tpu_torch.utils.imports")
    if probes is not None:
        importlib.reload(probes)


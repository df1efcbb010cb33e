"""MineDojo wrapper (counterpart of ``sheeprl_tpu/envs/minedojo.py``).

A 19-way discrete movement/functional action head plus craft and
equip/place/destroy item heads (MultiDiscrete), sticky attack/jump counters,
pitch limiting, and a dict observation exposing per-item inventory vectors,
equipment one-hot, life stats, and the ``mask_*`` keys DreamerV3's
mask-aware acting reads (``algos/dreamer_v3/minedojo_actor.py``), over the
port's spaces. Import-gated on ``minedojo``.

As in the JAX package, a functional action other than attack sets
``self._sticky_attack`` (the length, not the counter) to 0, which turns
sticky attack off for the rest of the wrapper's life.
"""

from __future__ import annotations

from sheeprl_tpu_torch.utils.imports import _IS_MINEDOJO_AVAILABLE

if not _IS_MINEDOJO_AVAILABLE:
    raise ModuleNotFoundError("minedojo is required: pip install minedojo")

import copy
from typing import Any, Dict, Optional, Tuple

import minedojo
import numpy as np
from minedojo.sim import ALL_CRAFT_SMELT_ITEMS, ALL_ITEMS

from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.wrappers import Wrapper

N_ALL_ITEMS = len(ALL_ITEMS)
ITEM_ID_TO_NAME = dict(enumerate(ALL_ITEMS))
ITEM_NAME_TO_ID = {name: i for i, name in enumerate(ALL_ITEMS)}

# 19 composite actions over MineDojo's 8-dim action space
# [move, strafe, jump/sneak/sprint, pitch, yaw, functional, craft-arg, item-arg]
# (camera deltas are ±15° around the 12 no-op bin)
ACTION_MAP = {
    0: np.array([0, 0, 0, 12, 12, 0, 0, 0]),  # no-op
    1: np.array([1, 0, 0, 12, 12, 0, 0, 0]),  # forward
    2: np.array([2, 0, 0, 12, 12, 0, 0, 0]),  # back
    3: np.array([0, 1, 0, 12, 12, 0, 0, 0]),  # strafe left
    4: np.array([0, 2, 0, 12, 12, 0, 0, 0]),  # strafe right
    5: np.array([1, 0, 1, 12, 12, 0, 0, 0]),  # jump + forward
    6: np.array([1, 0, 2, 12, 12, 0, 0, 0]),  # sneak + forward
    7: np.array([1, 0, 3, 12, 12, 0, 0, 0]),  # sprint + forward
    8: np.array([0, 0, 0, 11, 12, 0, 0, 0]),  # pitch -15
    9: np.array([0, 0, 0, 13, 12, 0, 0, 0]),  # pitch +15
    10: np.array([0, 0, 0, 12, 11, 0, 0, 0]),  # yaw -15
    11: np.array([0, 0, 0, 12, 13, 0, 0, 0]),  # yaw +15
    12: np.array([0, 0, 0, 12, 12, 1, 0, 0]),  # use
    13: np.array([0, 0, 0, 12, 12, 2, 0, 0]),  # drop
    14: np.array([0, 0, 0, 12, 12, 3, 0, 0]),  # attack
    15: np.array([0, 0, 0, 12, 12, 4, 0, 0]),  # craft
    16: np.array([0, 0, 0, 12, 12, 5, 0, 0]),  # equip
    17: np.array([0, 0, 0, 12, 12, 6, 0, 0]),  # place
    18: np.array([0, 0, 0, 12, 12, 7, 0, 0]),  # destroy
}
MASK_KEYS = ("mask_action_type", "mask_craft_smelt", "mask_equip_place", "mask_destroy")


def _canon(item: str) -> str:
    return "_".join(item.split(" "))


class MineDojoWrapper(Wrapper):
    def __init__(
        self,
        id: str,
        height: int = 64,
        width: int = 64,
        pitch_limits: Tuple[int, int] = (-60, 60),
        seed: Optional[int] = None,
        sticky_attack: Optional[int] = 30,
        sticky_jump: Optional[int] = 10,
        **kwargs: Any,
    ):
        self._height = height
        self._width = width
        self._pitch_limits = pitch_limits
        self._pos = kwargs.pop("start_position", None)
        self._break_speed_multiplier = kwargs.pop("break_speed_multiplier", 100)
        self._start_pos = copy.deepcopy(self._pos)
        self._sticky_attack = sticky_attack or 0
        self._sticky_jump = sticky_jump or 0
        self._sticky_attack_counter = 0
        self._sticky_jump_counter = 0

        if self._pos is not None and not (self._pitch_limits[0] <= self._pos["pitch"] <= self._pitch_limits[1]):
            raise ValueError(
                f"The initial position must respect the pitch limits {self._pitch_limits}, "
                f"given {self._pos['pitch']}"
            )

        super().__init__(
            minedojo.make(
                task_id=id,
                image_size=(height, width),
                world_seed=seed,
                start_position=self._pos,
                generate_world_type="default",
                fast_reset=True,
                break_speed_multiplier=self._break_speed_multiplier,
                **kwargs,
            )
        )
        self._inventory: Dict[str, list] = {}
        self._inventory_names: Optional[np.ndarray] = None
        self._inventory_max = np.zeros(N_ALL_ITEMS)
        self.action_space = spaces.MultiDiscrete(np.array([len(ACTION_MAP), len(ALL_CRAFT_SMELT_ITEMS), N_ALL_ITEMS]))
        self.observation_space = spaces.Dict(
            {
                "rgb": spaces.Box(0, 255, self.env.observation_space["rgb"].shape, np.uint8),
                "inventory": spaces.Box(0.0, np.inf, (N_ALL_ITEMS,), np.float32),
                "inventory_max": spaces.Box(0.0, np.inf, (N_ALL_ITEMS,), np.float32),
                "inventory_delta": spaces.Box(-np.inf, np.inf, (N_ALL_ITEMS,), np.float32),
                "equipment": spaces.Box(0.0, 1.0, (N_ALL_ITEMS,), np.int32),
                "life_stats": spaces.Box(0.0, np.array([20.0, 20.0, 300.0]), (3,), np.float32),
                "mask_action_type": spaces.Box(0, 1, (len(ACTION_MAP),), bool),
                "mask_equip_place": spaces.Box(0, 1, (N_ALL_ITEMS,), bool),
                "mask_destroy": spaces.Box(0, 1, (N_ALL_ITEMS,), bool),
                "mask_craft_smelt": spaces.Box(0, 1, (len(ALL_CRAFT_SMELT_ITEMS),), bool),
            }
        )
        self.render_mode = "rgb_array"
        self.seed(seed=seed)

    # -- observation conversion --------------------------------------------

    def _convert_inventory(self, inventory: Dict[str, Any]) -> np.ndarray:
        counts = np.zeros(N_ALL_ITEMS)
        self._inventory = {}
        self._inventory_names = np.array([_canon(n) for n in inventory["name"].tolist()])
        for slot, (name, quantity) in enumerate(zip(inventory["name"], inventory["quantity"])):
            name = _canon(name)
            self._inventory.setdefault(name, []).append(slot)
            counts[ITEM_NAME_TO_ID[name]] += 1 if name == "air" else quantity
        self._inventory_max = np.maximum(counts, self._inventory_max)
        return counts

    def _convert_inventory_delta(self, delta: Dict[str, Any]) -> np.ndarray:
        out = np.zeros(N_ALL_ITEMS)
        for names_key, qty_key, sign in (
            ("inc_name_by_craft", "inc_quantity_by_craft", +1),
            ("dec_name_by_craft", "dec_quantity_by_craft", -1),
            ("inc_name_by_other", "inc_quantity_by_other", +1),
            ("dec_name_by_other", "dec_quantity_by_other", -1),
        ):
            for name, quantity in zip(delta[names_key], delta[qty_key]):
                out[ITEM_NAME_TO_ID[_canon(name)]] += sign * quantity
        return out

    def _convert_equipment(self, equipment: Dict[str, Any]) -> np.ndarray:
        equip = np.zeros(N_ALL_ITEMS, dtype=np.int32)
        equip[ITEM_NAME_TO_ID[_canon(equipment["name"][0])]] = 1
        return equip

    def _convert_masks(self, masks: Dict[str, Any]) -> Dict[str, np.ndarray]:
        equip_mask = np.zeros(N_ALL_ITEMS, dtype=bool)
        destroy_mask = np.zeros(N_ALL_ITEMS, dtype=bool)
        for name, can_equip, can_destroy in zip(self._inventory_names, masks["equip"], masks["destroy"]):
            idx = ITEM_NAME_TO_ID[name]
            equip_mask[idx] = can_equip
            destroy_mask[idx] = can_destroy
        # equip/place (ids 16/17) need an equippable item, destroy (18) one to destroy: the simulator's own
        # action-type mask is narrowed in place
        masks["action_type"][5:7] *= bool(np.any(equip_mask))
        masks["action_type"][7] *= bool(np.any(destroy_mask))
        return {
            "mask_action_type": np.concatenate((np.ones(12, dtype=bool), masks["action_type"][1:])),
            "mask_equip_place": equip_mask,
            "mask_destroy": destroy_mask,
            "mask_craft_smelt": masks["craft_smelt"],
        }

    def _convert_obs(self, obs: Dict[str, Any]) -> Dict[str, np.ndarray]:
        return {
            "rgb": obs["rgb"].copy(),
            "inventory": self._convert_inventory(obs["inventory"]),
            "inventory_max": self._inventory_max,
            "inventory_delta": self._convert_inventory_delta(obs["delta_inv"]),
            "equipment": self._convert_equipment(obs["equipment"]),
            "life_stats": np.concatenate(
                (obs["life_stats"]["life"], obs["life_stats"]["food"], obs["life_stats"]["oxygen"])
            ),
            **self._convert_masks(obs["masks"]),
        }

    # -- action conversion with sticky attack/jump -------------------------

    def _convert_action(self, action: np.ndarray) -> np.ndarray:
        converted = ACTION_MAP[int(action[0])].copy()
        if self._sticky_attack:
            if converted[5] == 3:  # attack selected
                self._sticky_attack_counter = self._sticky_attack - 1
            if self._sticky_attack_counter > 0 and converted[5] == 0:
                converted[5] = 3
                self._sticky_attack_counter -= 1
            elif converted[5] != 3:
                self._sticky_attack = 0  # as in the JAX package: turns sticky attack off for good
        if self._sticky_jump:
            if converted[2] == 1:  # jump selected
                self._sticky_jump_counter = self._sticky_jump - 1
            if self._sticky_jump_counter > 0 and converted[0] == 0:
                converted[2] = 1
                if converted[0] == converted[1] == 0:
                    converted[0] = 1  # keep moving while the sticky jump lasts
                self._sticky_jump_counter -= 1
            elif converted[2] != 1:
                self._sticky_jump_counter = 0
        converted[6] = int(action[1]) if converted[5] == 4 else 0
        if converted[5] in (5, 6, 7):
            converted[7] = self._inventory[ITEM_ID_TO_NAME[int(action[2])]][0]
        else:
            converted[7] = 0
        return converted

    def seed(self, seed: Optional[int] = None) -> None:
        self.observation_space.seed(seed)
        self.action_space.seed(seed)

    def _location_info(self, obs) -> Dict[str, float]:
        return {
            "x": float(obs["location_stats"]["pos"][0]),
            "y": float(obs["location_stats"]["pos"][1]),
            "z": float(obs["location_stats"]["pos"][2]),
            "pitch": float(obs["location_stats"]["pitch"].item()),
            "yaw": float(obs["location_stats"]["yaw"].item()),
        }

    def _life_info(self, obs) -> Dict[str, float]:
        return {
            "life": float(obs["life_stats"]["life"].item()),
            "oxygen": float(obs["life_stats"]["oxygen"].item()),
            "food": float(obs["life_stats"]["food"].item()),
        }

    def step(self, action: np.ndarray):
        raw = action
        action = self._convert_action(action)
        next_pitch = self._pos["pitch"] + (action[3] - 12) * 15
        if not (self._pitch_limits[0] <= next_pitch <= self._pitch_limits[1]):
            action[3] = 12  # clamp the camera at the pitch limits

        obs, reward, done, _ = self.env.step(action)
        self._pos = self._location_info(obs)
        info = {
            "life_stats": self._life_info(obs),
            "location_stats": copy.deepcopy(self._pos),
            "action": np.asarray(raw).tolist(),
            "biomeid": float(obs["location_stats"]["biome_id"].item()),
        }
        return self._convert_obs(obs), reward, done, False, info

    def reset(self, *, seed: Optional[int] = None, options: Optional[Dict[str, Any]] = None):
        obs = self.env.reset()
        self._pos = self._location_info(obs)
        self._sticky_jump_counter = 0
        self._sticky_attack_counter = 0
        self._inventory_max = np.zeros(N_ALL_ITEMS)
        return self._convert_obs(obs), {
            "life_stats": self._life_info(obs),
            "location_stats": copy.deepcopy(self._pos),
            "biomeid": float(obs["location_stats"]["biome_id"].item()),
        }

    def render(self):
        if self.render_mode == "human":
            return self.env.render()
        if self.render_mode == "rgb_array":
            prev = self.env.unwrapped._prev_obs
            return None if prev is None else prev["rgb"]
        return None

    @property
    def unwrapped(self):
        return self

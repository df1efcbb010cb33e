"""MineRL wrapper (counterpart of ``sheeprl_tpu/envs/minerl.py``).

The custom Navigate / Obtain tasks behind a *discrete* action head built by
enumerating the MineRL dict action space (enum values, binary keys, four
±15° camera moves), sticky attack/jump, pitch/yaw tracking with pitch
limits, and a dict observation with CHW pixels, life stats, (multi-hot)
inventory / max-inventory, equipment one-hot, and the compass angle, over
the port's spaces. Import-gated on ``minerl``.
"""

from __future__ import annotations

from sheeprl_tpu_torch.utils.imports import _IS_MINERL_AVAILABLE

if not _IS_MINERL_AVAILABLE:
    raise ModuleNotFoundError("minerl is required: pip install minerl==0.4.4")

import copy
from typing import Any, Dict, Optional, Tuple

import minerl
import numpy as np
from minerl.herobraine.hero import mc

from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.minerl_envs.navigate import CustomNavigate
from sheeprl_tpu_torch.envs.minerl_envs.obtain import CustomObtainDiamond, CustomObtainIronPickaxe
from sheeprl_tpu_torch.envs.wrappers import Wrapper

CUSTOM_ENVS = {
    "custom_navigate": CustomNavigate,
    "custom_obtain_diamond": CustomObtainDiamond,
    "custom_obtain_iron_pickaxe": CustomObtainIronPickaxe,
}

N_ALL_ITEMS = len(mc.ALL_ITEMS)
ITEM_ID_TO_NAME = dict(enumerate(mc.ALL_ITEMS))
ITEM_NAME_TO_ID = {name: i for i, name in enumerate(mc.ALL_ITEMS)}

NOOP = {
    "camera": (0, 0),
    "forward": 0,
    "back": 0,
    "left": 0,
    "right": 0,
    "attack": 0,
    "sprint": 0,
    "jump": 0,
    "sneak": 0,
    "craft": "none",
    "nearbyCraft": "none",
    "nearbySmelt": "none",
    "place": "none",
    "equip": "none",
}

_CAMERA_MOVES = (
    np.array([-15, 0]),
    np.array([15, 0]),
    np.array([0, -15]),
    np.array([0, 15]),
)


class MineRLWrapper(Wrapper):
    def __init__(
        self,
        id: str,
        height: int = 64,
        width: int = 64,
        pitch_limits: Tuple[int, int] = (-60, 60),
        seed: Optional[int] = None,
        sticky_attack: Optional[int] = 30,
        sticky_jump: Optional[int] = 10,
        break_speed_multiplier: Optional[int] = 100,
        multihot_inventory: bool = True,
        **kwargs: Any,
    ):
        self._height = height
        self._width = width
        self._pitch_limits = pitch_limits
        self._sticky_attack = sticky_attack or 0
        self._sticky_jump = sticky_jump or 0
        self._sticky_attack_counter = 0
        self._sticky_jump_counter = 0
        self._break_speed_multiplier = break_speed_multiplier
        self._multihot_inventory = multihot_inventory
        if "navigate" not in id.lower():
            kwargs.pop("extreme", None)

        super().__init__(CUSTOM_ENVS[id.lower()](break_speed=break_speed_multiplier, **kwargs).make())

        # Discrete head over the MineRL dict action space: index 0 is no-op; enum actions contribute one index per
        # value, binary keys one index, the camera four ±15° moves
        self.ACTIONS_MAP: Dict[int, Dict[str, Any]] = {0: {}}
        idx = 1
        for act, space in self.env.action_space.spaces.items():
            if isinstance(space, minerl.herobraine.hero.spaces.Enum):
                values = sorted(set(space.values.tolist()) - {"none"})
            elif act == "camera":
                values = list(_CAMERA_MOVES)
            else:
                values = [1]
            for v in values:
                entry = {act: v}
                if act in ("jump", "sneak", "sprint"):
                    entry["forward"] = 1
                self.ACTIONS_MAP[idx] = entry
                idx += 1
        self.action_space = spaces.Discrete(len(self.ACTIONS_MAP))

        if multihot_inventory:
            self.inventory_size = N_ALL_ITEMS
            self.inventory_item_to_id = ITEM_NAME_TO_ID
        else:
            inv_items = list(self.env.observation_space["inventory"].spaces)
            self.inventory_size = len(inv_items)
            self.inventory_item_to_id = {item: i for i, item in enumerate(inv_items)}

        obs_space = {
            "rgb": spaces.Box(0, 255, (3, height, width), np.uint8),
            "life_stats": spaces.Box(0.0, np.array([20.0, 20.0, 300.0]), (3,), np.float32),
            "inventory": spaces.Box(0.0, np.inf, (self.inventory_size,), np.float32),
            "max_inventory": spaces.Box(0.0, np.inf, (self.inventory_size,), np.float32),
        }
        if "compass" in self.env.observation_space.spaces:
            obs_space["compass"] = spaces.Box(-180, 180, (1,), np.float32)
        if "equipped_items" in self.env.observation_space.spaces:
            if multihot_inventory:
                self.equip_size = N_ALL_ITEMS
                self.equip_item_to_id = ITEM_NAME_TO_ID
            else:
                equip_items = self.env.observation_space["equipped_items"]["mainhand"]["type"].values.tolist()
                self.equip_size = len(equip_items)
                self.equip_item_to_id = {item: i for i, item in enumerate(equip_items)}
            obs_space["equipment"] = spaces.Box(0.0, 1.0, (self.equip_size,), np.int32)
        self.observation_space = spaces.Dict(obs_space)

        self._pos = {"pitch": 0.0, "yaw": 0.0}
        self._max_inventory = np.zeros(self.inventory_size)
        self.render_mode = "rgb_array"
        self.seed(seed=seed)

    def _convert_actions(self, action: np.ndarray) -> Dict[str, Any]:
        converted = copy.deepcopy(NOOP)
        converted.update(self.ACTIONS_MAP[int(np.asarray(action).item())])
        if self._sticky_attack:
            if converted["attack"]:
                self._sticky_attack_counter = self._sticky_attack
            if self._sticky_attack_counter > 0:
                converted["attack"] = 1
                converted["jump"] = 0
                self._sticky_attack_counter -= 1
        if self._sticky_jump:
            if converted["jump"]:
                self._sticky_jump_counter = self._sticky_jump
            if self._sticky_jump_counter > 0:
                converted["jump"] = 1
                converted["forward"] = 1
                self._sticky_jump_counter -= 1
        return converted

    def _convert_equipment(self, equipment: Dict[str, Any]) -> np.ndarray:
        equip = np.zeros(self.equip_size, dtype=np.int32)
        equip[self.equip_item_to_id.get(equipment["mainhand"]["type"], self.equip_item_to_id["air"])] = 1
        return equip

    def _convert_inventory(self, inventory: Dict[str, Any]) -> Dict[str, np.ndarray]:
        counts = np.zeros(self.inventory_size)
        for item, quantity in inventory.items():
            counts[self.inventory_item_to_id[item]] += 1 if item == "air" else quantity
        self._max_inventory = np.maximum(counts, self._max_inventory)
        return {"inventory": counts, "max_inventory": self._max_inventory.copy()}

    def _convert_obs(self, obs: Dict[str, Any]) -> Dict[str, np.ndarray]:
        converted = {
            "rgb": obs["pov"].copy().transpose(2, 0, 1),
            "life_stats": np.array(
                [obs["life_stats"]["life"], obs["life_stats"]["food"], obs["life_stats"]["air"]], dtype=np.float32
            ),
            **self._convert_inventory(obs["inventory"]),
        }
        if "equipment" in self.observation_space.spaces:
            converted["equipment"] = self._convert_equipment(obs["equipped_items"])
        if "compass" in self.observation_space.spaces:
            converted["compass"] = np.asarray(obs["compass"]["angle"]).reshape(-1)
        return converted

    def seed(self, seed: Optional[int] = None) -> None:
        self.observation_space.seed(seed)
        self.action_space.seed(seed)

    def step(self, actions: np.ndarray):
        converted = self._convert_actions(actions)
        next_pitch = self._pos["pitch"] + converted["camera"][0]
        next_yaw = ((self._pos["yaw"] + converted["camera"][1]) + 180) % 360 - 180
        if not (self._pitch_limits[0] <= next_pitch <= self._pitch_limits[1]):
            converted["camera"] = np.array([0, converted["camera"][1]])
            next_pitch = self._pos["pitch"]

        obs, reward, done, _ = self.env.step(converted)
        self._pos = {"pitch": next_pitch, "yaw": next_yaw}
        return self._convert_obs(obs), reward, done, False, {}

    def reset(self, *, seed: Optional[int] = None, options: Optional[Dict[str, Any]] = None):
        obs = self.env.reset()
        self._max_inventory = np.zeros(self.inventory_size)
        self._sticky_attack_counter = 0
        self._sticky_jump_counter = 0
        self._pos = {"pitch": 0.0, "yaw": 0.0}
        return self._convert_obs(obs), {}

    def render(self, mode: Optional[str] = "rgb_array"):
        return self.env.render(self.render_mode)

    @property
    def unwrapped(self):
        return self

"""Custom MineRL Obtain tasks (counterpart of
``sheeprl_tpu/envs/minerl_envs/obtain.py``): survival-start item
hierarchies with staged rewards up to a diamond / iron pickaxe."""

from __future__ import annotations

from sheeprl_tpu_torch.utils.imports import _IS_MINERL_AVAILABLE

if not _IS_MINERL_AVAILABLE:
    raise ModuleNotFoundError("minerl is required: pip install minerl==0.4.4")

from typing import Dict, List, Union

import minerl.herobraine.hero.handlers as handlers
from minerl.herobraine.hero.handler import Handler
from minerl.herobraine.hero.mc import MS_PER_STEP

from sheeprl_tpu_torch.envs.minerl_envs.backend import CustomSimpleEmbodimentEnvSpec

_NONE = "none"
_OTHER = "other"

_INVENTORY_ITEMS = [
    "dirt", "coal", "torch", "log", "planks", "stick", "crafting_table",
    "wooden_axe", "wooden_pickaxe", "stone", "cobblestone", "furnace",
    "stone_axe", "stone_pickaxe", "iron_ore", "iron_ingot", "iron_axe",
    "iron_pickaxe",
]
_EQUIP_ITEMS = [
    "air", "wooden_axe", "wooden_pickaxe", "stone_axe", "stone_pickaxe",
    "iron_axe", "iron_pickaxe",
]


def _snake_to_camel(s: str) -> str:
    return "".join(p.title() for p in s.split("_"))


class CustomObtain(CustomSimpleEmbodimentEnvSpec):
    def __init__(
        self,
        target_item: str,
        dense: bool,
        reward_schedule: List[Dict[str, Union[str, int, float]]],
        *args,
        max_episode_steps: int = 6000,
        **kwargs,
    ):
        self.target_item = target_item
        self.dense = dense
        self.reward_schedule = reward_schedule
        suffix = _snake_to_camel(target_item) + ("Dense" if dense else "")
        super().__init__(
            *args,
            name=f"CustomMineRLObtain{suffix}-v0",
            max_episode_steps=max_episode_steps,
            **kwargs,
        )

    def create_observables(self) -> List[Handler]:
        return super().create_observables() + [
            handlers.FlatInventoryObservation(_INVENTORY_ITEMS),
            handlers.EquippedItemObservation(
                items=_EQUIP_ITEMS + [_OTHER], _default="air", _other=_OTHER
            ),
        ]

    def create_actionables(self):
        return super().create_actionables() + [
            handlers.PlaceBlock(
                [_NONE, "dirt", "stone", "cobblestone", "crafting_table", "furnace", "torch"],
                _other=_NONE, _default=_NONE,
            ),
            handlers.EquipAction([_NONE] + _EQUIP_ITEMS, _other=_NONE, _default=_NONE),
            handlers.CraftAction(
                [_NONE, "torch", "stick", "planks", "crafting_table"], _other=_NONE, _default=_NONE
            ),
            handlers.CraftNearbyAction(
                [_NONE, "wooden_axe", "wooden_pickaxe", "stone_axe", "stone_pickaxe",
                 "iron_axe", "iron_pickaxe", "furnace"],
                _other=_NONE, _default=_NONE,
            ),
            handlers.SmeltItemNearby([_NONE, "iron_ingot", "coal"], _other=_NONE, _default=_NONE),
        ]

    def create_rewardables(self) -> List[Handler]:
        reward_handler = (
            handlers.RewardForCollectingItems if self.dense else handlers.RewardForCollectingItemsOnce
        )
        return [reward_handler(self.reward_schedule or {self.target_item: 1})]

    def create_agent_start(self) -> List[Handler]:
        return super().create_agent_start()

    def create_agent_handlers(self) -> List[Handler]:
        return [handlers.AgentQuitFromPossessingItem([dict(type="diamond", amount=1)])]

    def create_server_world_generators(self) -> List[Handler]:
        return [handlers.DefaultWorldGenerator(force_reset=True)]

    def create_server_quit_producers(self) -> List[Handler]:
        return [
            handlers.ServerQuitFromTimeUp(time_limit_ms=self.max_episode_steps * MS_PER_STEP),
            handlers.ServerQuitWhenAnyAgentFinishes(),
        ]

    def create_server_decorators(self) -> List[Handler]:
        return []

    def create_server_initial_conditions(self) -> List[Handler]:
        return [
            handlers.TimeInitialCondition(start_time=6000, allow_passage_of_time=True),
            handlers.SpawningInitialCondition(allow_spawning=True),
        ]

    def is_from_folder(self, folder: str) -> bool:
        return folder == f"o_{self.target_item}"

    def get_docstring(self) -> str:
        return f"Obtain a {self.target_item} starting from survival conditions."

    def determine_success_from_rewards(self, rewards: list) -> bool:
        rewards = set(rewards)
        max_missing = round(len(self.reward_schedule) * 0.1)
        reward_values = [s["reward"] for s in self.reward_schedule]
        return len(rewards.intersection(reward_values)) >= len(reward_values) - max_missing


class CustomObtainDiamond(CustomObtain):
    def __init__(self, dense: bool = False, *args, **kwargs):
        super().__init__(
            *args,
            target_item="diamond",
            dense=dense,
            reward_schedule=[
                dict(type="log", amount=1, reward=1),
                dict(type="planks", amount=1, reward=2),
                dict(type="stick", amount=1, reward=4),
                dict(type="crafting_table", amount=1, reward=4),
                dict(type="wooden_pickaxe", amount=1, reward=8),
                dict(type="cobblestone", amount=1, reward=16),
                dict(type="furnace", amount=1, reward=32),
                dict(type="stone_pickaxe", amount=1, reward=32),
                dict(type="iron_ore", amount=1, reward=64),
                dict(type="iron_ingot", amount=1, reward=128),
                dict(type="iron_pickaxe", amount=1, reward=256),
                dict(type="diamond", amount=1, reward=1024),
            ],
            max_episode_steps=18000,
            **kwargs,
        )

    def is_from_folder(self, folder: str) -> bool:
        return folder == "o_dia"


class CustomObtainIronPickaxe(CustomObtain):
    def __init__(self, dense: bool = False, *args, **kwargs):
        super().__init__(
            *args,
            target_item="iron_pickaxe",
            dense=dense,
            reward_schedule=[
                dict(type="log", amount=1, reward=1),
                dict(type="planks", amount=1, reward=2),
                dict(type="stick", amount=1, reward=4),
                dict(type="crafting_table", amount=1, reward=4),
                dict(type="wooden_pickaxe", amount=1, reward=8),
                dict(type="cobblestone", amount=1, reward=16),
                dict(type="furnace", amount=1, reward=32),
                dict(type="stone_pickaxe", amount=1, reward=32),
                dict(type="iron_ore", amount=1, reward=64),
                dict(type="iron_ingot", amount=1, reward=128),
                dict(type="iron_pickaxe", amount=1, reward=256),
            ],
            max_episode_steps=6000,
            **kwargs,
        )

    def is_from_folder(self, folder: str) -> bool:
        return folder == "o_iron"

"""Custom MineRL Navigate task (counterpart of
``sheeprl_tpu/envs/minerl_envs/navigate.py``): reach a diamond block
guided by a compass; +100 on touch, optional dense per-block shaping."""

from __future__ import annotations

from sheeprl_tpu_torch.utils.imports import _IS_MINERL_AVAILABLE

if not _IS_MINERL_AVAILABLE:
    raise ModuleNotFoundError("minerl is required: pip install minerl==0.4.4")

from typing import List

import minerl.herobraine.hero.handlers as handlers
from minerl.herobraine.hero.handler import Handler
from minerl.herobraine.hero.mc import MS_PER_STEP

from sheeprl_tpu_torch.envs.minerl_envs.backend import CustomSimpleEmbodimentEnvSpec

NAVIGATE_STEPS = 6000


class CustomNavigate(CustomSimpleEmbodimentEnvSpec):
    def __init__(self, dense: bool = False, extreme: bool = False, *args, **kwargs):
        suffix = ("Extreme" if extreme else "") + ("Dense" if dense else "")
        self.dense, self.extreme = dense, extreme
        super().__init__(
            f"CustomMineRLNavigate{suffix}-v0", *args, max_episode_steps=NAVIGATE_STEPS, **kwargs
        )

    def is_from_folder(self, folder: str) -> bool:
        return folder == ("navigateextreme" if self.extreme else "navigate")

    def create_observables(self) -> List[Handler]:
        return super().create_observables() + [
            handlers.CompassObservation(angle=True, distance=False),
            handlers.FlatInventoryObservation(["dirt"]),
        ]

    def create_actionables(self) -> List[Handler]:
        return super().create_actionables() + [
            handlers.PlaceBlock(["none", "dirt"], _other="none", _default="none")
        ]

    def create_rewardables(self) -> List[Handler]:
        rewards = [
            handlers.RewardForTouchingBlockType(
                [{"type": "diamond_block", "behaviour": "onceOnly", "reward": 100.0}]
            )
        ]
        if self.dense:
            rewards.append(handlers.RewardForDistanceTraveledToCompassTarget(reward_per_block=1.0))
        return rewards

    def create_agent_start(self) -> List[Handler]:
        return super().create_agent_start() + [
            handlers.SimpleInventoryAgentStart([dict(type="compass", quantity="1")])
        ]

    def create_agent_handlers(self) -> List[Handler]:
        return [handlers.AgentQuitFromTouchingBlockType(["diamond_block"])]

    def create_server_world_generators(self) -> List[Handler]:
        if self.extreme:
            return [handlers.BiomeGenerator(biome=3, force_reset=True)]
        return [handlers.DefaultWorldGenerator(force_reset=True)]

    def create_server_quit_producers(self) -> List[Handler]:
        return [
            handlers.ServerQuitFromTimeUp(NAVIGATE_STEPS * MS_PER_STEP),
            handlers.ServerQuitWhenAnyAgentFinishes(),
        ]

    def create_server_decorators(self) -> List[Handler]:
        return [
            handlers.NavigationDecorator(
                max_randomized_radius=64,
                min_randomized_radius=64,
                block="diamond_block",
                placement="surface",
                max_radius=8,
                min_radius=0,
                max_randomized_distance=8,
                min_randomized_distance=0,
                randomize_compass_location=True,
            )
        ]

    def create_server_initial_conditions(self) -> List[Handler]:
        return [
            handlers.TimeInitialCondition(allow_passage_of_time=False, start_time=6000),
            handlers.WeatherInitialCondition("clear"),
            handlers.SpawningInitialCondition("false"),
        ]

    def get_docstring(self) -> str:
        return "Navigate to the diamond block indicated by the compass."

    def determine_success_from_rewards(self, rewards: list) -> bool:
        threshold = 100.0 + (60.0 if self.dense else 0.0)
        return sum(rewards) >= threshold

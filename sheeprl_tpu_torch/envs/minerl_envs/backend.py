"""Base spec for the custom MineRL tasks (counterpart of
``sheeprl_tpu/envs/minerl_envs/backend.py``, adapted from
minerllabs/minerl): a simple-embodiment EnvSpec with a configurable
resolution and a Malmo ``BreakSpeedMultiplier`` handler (after
danijar/diamond_env). Import-gated on ``minerl``."""

from __future__ import annotations

from sheeprl_tpu_torch.utils.imports import _IS_MINERL_AVAILABLE

if not _IS_MINERL_AVAILABLE:
    raise ModuleNotFoundError("minerl is required: pip install minerl==0.4.4")

from abc import ABC
from typing import List

from minerl.herobraine.env_spec import EnvSpec
from minerl.herobraine.hero import handler, handlers
from minerl.herobraine.hero.handlers.translation import TranslationHandler
from minerl.herobraine.hero.mc import INVERSE_KEYMAP

SIMPLE_KEYBOARD_ACTION = ["forward", "back", "left", "right", "jump", "sneak", "sprint", "attack"]


class BreakSpeedMultiplier(handler.Handler):
    """Malmo agent-start handler speeding up block breaking."""

    def __init__(self, multiplier: float = 1.0):
        self.multiplier = multiplier

    def to_string(self):
        return f"break_speed({self.multiplier})"

    def xml_template(self):
        return "<BreakSpeedMultiplier>{{multiplier}}</BreakSpeedMultiplier>"


class CustomSimpleEmbodimentEnvSpec(EnvSpec, ABC):
    """POV + location + life-stats observables, simple keyboard + camera
    actionables, and the break-speed agent-start handler."""

    def __init__(self, name, *args, resolution=(64, 64), break_speed: int = 100, **kwargs):
        self.resolution = resolution
        self.break_speed = break_speed
        super().__init__(name, *args, **kwargs)

    def create_agent_start(self):
        return [BreakSpeedMultiplier(self.break_speed)]

    def create_observables(self) -> List[TranslationHandler]:
        return [
            handlers.POVObservation(self.resolution),
            handlers.ObservationFromCurrentLocation(),
            handlers.ObservationFromLifeStats(),
        ]

    def create_actionables(self) -> List[TranslationHandler]:
        return [
            handlers.KeybasedCommandAction(k, v)
            for k, v in INVERSE_KEYMAP.items()
            if k in SIMPLE_KEYBOARD_ACTION
        ] + [handlers.CameraAction()]

    def create_monitors(self) -> List[TranslationHandler]:
        return []

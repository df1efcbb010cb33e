"""The port's config tree (``configs/**/*.yaml``, composed by
:func:`sheeprl_tpu_torch.config.compose`) and the DreamerV2 and DreamerV3
presets the serving and training slices read."""

from __future__ import annotations

from typing import Any

from sheeprl_tpu_torch.utils import dotdict

__all__ = ["dreamer_v2_config", "dreamer_v3_config"]


def dreamer_v2_config(exp: str = "dreamer_v2_ms_pacman", **overrides: Any) -> dotdict:
    """The composed ``exp=<exp>`` config (MsPacman by default) with dotted-key
    overrides, e.g. ``dreamer_v2_config(seed=42, **{"algo.dense_units": 32})``.
    Overrides apply before interpolation, so overriding a root such as
    ``algo.dense_units`` moves every field that follows it. A key the
    composed tree does not have raises ``KeyError``."""
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.config.yamlite import flow

    base = [f"exp={exp}"]
    tree = compose(overrides=base, resolve=False)
    for key in overrides:
        node = tree
        for part in key.split("."):
            if not isinstance(node, dict) or part not in node:
                raise KeyError(f"{exp}: unknown key {key!r}")
            node = node[part]
    return compose(overrides=base + [f"{k}={flow(v)}" for k, v in overrides.items()])


def dreamer_v3_config(exp: str = "dreamer_v3_100k_ms_pacman", **overrides: Any) -> dotdict:
    """:func:`dreamer_v2_config` for the DreamerV3 presets (the Atari-100K
    MsPacman one by default)."""
    return dreamer_v2_config(exp, **overrides)

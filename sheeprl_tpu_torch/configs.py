"""The DreamerV2 configuration the serving slice reads.

Values are those of the JAX package's YAML tree: ``configs/algo/default.yaml``,
``configs/algo/dreamer_v2.yaml`` and ``configs/exp/dreamer_v2_ms_pacman.yaml``
(MsPacman, Atari 64x64 rgb). Only the fields that ``build_agent`` and
``build_player_fns`` read are kept; the config engine and the YAML tree are
not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict

from sheeprl_tpu_torch.utils import dotdict

__all__ = ["dreamer_v2_config"]

#: the keys other fields interpolate from (``${algo.dense_units}`` in YAML)
_ROOTS: Dict[str, Any] = {
    "algo.layer_norm": False,
    "algo.dense_units": 400,
    "algo.mlp_layers": 4,
    "algo.dense_act": "elu",
    "algo.cnn_act": "elu",
    "algo.world_model.encoder.cnn_channels_multiplier": 48,
}


def _tree(r: Dict[str, Any]) -> Dict[str, Any]:
    ln, units, layers = r["algo.layer_norm"], r["algo.dense_units"], r["algo.mlp_layers"]
    dense_act, cnn_act = r["algo.dense_act"], r["algo.cnn_act"]
    mult = r["algo.world_model.encoder.cnn_channels_multiplier"]

    def head():
        return {"dense_act": dense_act, "mlp_layers": layers, "layer_norm": ln, "dense_units": units}

    return {
        "seed": 5,
        "env": {"id": "MsPacmanNoFrameskip-v0", "screen_size": 64},
        "cnn_keys": {"encoder": ["rgb"]},
        "mlp_keys": {"encoder": []},
        "distribution": {"type": "auto"},
        "algo": {
            "name": "dreamer_v2",
            "layer_norm": ln,
            "dense_units": units,
            "mlp_layers": layers,
            "dense_act": dense_act,
            "cnn_act": cnn_act,
            "world_model": {
                "discrete_size": 32,
                "stochastic_size": 32,
                "use_continues": True,
                "encoder": {
                    "cnn_channels_multiplier": mult,
                    "cnn_act": cnn_act,
                    "dense_act": dense_act,
                    "mlp_layers": layers,
                    "layer_norm": ln,
                    "dense_units": units,
                },
                "recurrent_model": {
                    "recurrent_state_size": 600,
                    "layer_norm": True,
                    "dense_units": units,
                },
                "transition_model": {"hidden_size": 600, "dense_act": dense_act, "layer_norm": ln},
                "representation_model": {
                    "hidden_size": 600,
                    "dense_act": dense_act,
                    "layer_norm": ln,
                },
                "observation_model": {
                    "cnn_channels_multiplier": mult,
                    "cnn_act": cnn_act,
                    **head(),
                },
                "reward_model": head(),
                "discount_model": {"learnable": True, **head()},
            },
            "actor": {"min_std": 0.1, "init_std": 0.0, **head()},
            "critic": head(),
        },
    }


def _set(cfg: Dict[str, Any], dotted: str, value: Any) -> None:
    *parents, leaf = dotted.split(".")
    node = cfg
    for part in parents:
        if not isinstance(node.get(part), dict):
            raise KeyError(f"dreamer_v2_config: unknown key {dotted!r}")
        node = node[part]
    if leaf not in node:
        raise KeyError(f"dreamer_v2_config: unknown key {dotted!r}")
    node[leaf] = value


def dreamer_v2_config(**overrides: Any) -> dotdict:
    """The MsPacman DreamerV2 config, with dotted-key overrides, e.g.
    ``dreamer_v2_config(seed=42, **{"algo.dense_units": 32})``. Overriding an
    interpolation root (``algo.dense_units``, ``algo.mlp_layers``, ...) moves
    every field that follows it, as in the YAML tree. Unknown keys raise."""
    roots = dict(_ROOTS)
    rest = {}
    for key, value in overrides.items():
        (roots if key in roots else rest)[key] = value
    cfg = _tree(roots)
    for key, value in rest.items():
        _set(cfg, key, value)
    return dotdict(cfg)

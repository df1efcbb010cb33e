"""Carry DreamerV1, DreamerV2 and DreamerV3 weights across from the JAX package.

:func:`convert_dreamer_v1`, :func:`convert_dreamer_v2` and
:func:`convert_dreamer_v3` turn the JAX package's param trees (``{"world_model": ..., "actor": ...}`` as nested
dicts of numpy arrays, e.g. from ``jax.device_get``) into the port's
``state_dict``s:

- a Dense ``kernel [in, out]`` becomes a Linear ``weight [out, in]``;
- a Conv ``kernel`` HWIO becomes OIHW;
- a ``ConvTranspose`` kernel (``transpose_kernel=True``, stored as the HWIO
  kernel of the forward convolution it is the gradient of) becomes the
  ``ConvTranspose2d`` weight ``[in, out, kh, kw]`` by the same transpose,
  with no spatial flip;
- the LayerNorm-GRU's joint ``Dense_0/kernel [H+X, 3H]`` stays as it is:
  it is the layout the CUDA kernel and the plain version both read;
- DreamerV1's flax GRU (``gru/{ir,iz,in,hr,hz,hn}``) is six Dense layers,
  each becoming the Linear of the same name in ``models.GRUCell``;
- ``FastLayerNorm`` ``scale``/``bias`` become ``weight``/``bias``;
- DreamerV3's posterior trunk ``trunk_kernel [H+E, hidden]`` becomes the
  ``trunk`` Linear's weight (and a checkpoint of the earlier layout, an
  ``MLP_0`` under ``representation_model``, converts the same way);
- Plan2Explore's stacked ensemble (:func:`convert_p2e_dv3`,
  :func:`convert_p2e_dv2`, :func:`convert_p2e_dv1`): a Dense kernel ``[N, in, out]`` keeps its layout
  with the member axis first (``StackedLinear.weight``), its bias and the
  LayerNorm vectors ``[N, out]`` too.

Every leaf is either consumed or listed as skipped. A training conversion
(``training=True``) consumes every leaf of the four trees; a serving one
skips the parts a serving build does not have (decoders, reward and
continue heads, critic, target critic). An unknown leaf raises.
DreamerV1 and P2E-DV1 have no target critics.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

__all__ = [
    "SKIPPED_PREFIXES",
    "convert_dreamer_v1",
    "convert_dreamer_v2",
    "convert_dreamer_v3",
    "convert_layers",
    "convert_p2e_dv1",
    "convert_p2e_dv2",
    "convert_p2e_dv3",
]

#: parameters of parts that training needs and serving does not (per tree)
SKIPPED_PREFIXES: Dict[str, Tuple[str, ...]] = {
    "world_model": ("cnn_decoder/", "mlp_decoder/", "reward_model/", "continue_model/"),
}
#: whole trees serving does not need
SKIPPED_TREES = ("critic", "target_critic")
_TREES = ("world_model", "actor", "critic", "target_critic")
#: the trees of a family whose training tree set is not ``_TREES``
_FAMILY_TREES = {"dreamer_v1": ("world_model", "actor", "critic")}

_HWIO_TO_OIHW = (3, 2, 0, 1)
_GRU = "rssm/recurrent_model/gru"
_T = lambda k: k.T  # noqa: E731
_SAME = lambda a: a  # noqa: E731
#: the GRU cell's leaves, as the kernel reads them (no transpose)
_GRU_LEAVES = {
    f"{_GRU}/Dense_0/kernel": ("rssm.recurrent_model.gru.weight", _SAME),
    f"{_GRU}/Dense_0/bias": ("rssm.recurrent_model.gru.bias", _SAME),
    f"{_GRU}/LayerNorm_0/scale": ("rssm.recurrent_model.gru.norm.weight", _SAME),
    f"{_GRU}/LayerNorm_0/bias": ("rssm.recurrent_model.gru.norm.bias", _SAME),
}
#: DreamerV1's flax GRU cell: six Dense layers, each a Linear of the same name in ``models.GRUCell``
_FLAX_GRU_LEAVES = ("ir", "iz", "in", "hr", "hz", "hn")
_REPR = "rssm/representation_model"
_TRUNK = "rssm.representation_model.trunk"

# Per family and tree, JAX module path → port module path: ``mlp`` (MLP
# containers of Dense/LayerNorm leaves), ``cnn``/``decnn`` (Conv /
# ConvTranspose stacks), ``linear`` (one Dense), ``keyed`` (``<scope>/head_<key>``
# → ``<module>.<key>``) and ``leaves`` (single leaves with their transform).
_LAYOUTS: Dict[str, Dict[str, Dict[str, Any]]] = {
    "dreamer_v1": {
        "world_model": {
            "mlp": {
                "mlp_encoder/MLP_0": "mlp_encoder.mlp",
                "rssm/representation_model/MLP_0": "rssm.representation_model.mlp",
                "rssm/transition_model/MLP_0": "rssm.transition_model.mlp",
                "mlp_decoder/MLP_0": "mlp_decoder.mlp",
                "reward_model/MLP_0": "reward_model.mlp",
                "continue_model/MLP_0": "continue_model.mlp",
            },
            "cnn": {"cnn_encoder/CNN_0": "cnn_encoder.cnn"},
            "decnn": {"cnn_decoder/DeCNN_0": "cnn_decoder.decnn"},
            "linear": {
                "rssm/recurrent_model/Dense_0": "rssm.recurrent_model.linear",
                **{f"{_GRU}/{name}": f"rssm.recurrent_model.gru.{name}" for name in _FLAX_GRU_LEAVES},
                "rssm/representation_model/head": "rssm.representation_model.head",
                "rssm/transition_model/head": "rssm.transition_model.head",
                "cnn_decoder/Dense_0": "cnn_decoder.linear",
                "reward_model/head": "reward_model.head",
                "continue_model/head": "continue_model.head",
            },
            "keyed": ("mlp_decoder/head_", "mlp_decoder.heads."),
        },
        "actor": {"mlp": {"MLP_0": "mlp"}, "keyed": ("head_", "heads.")},
        "critic": {"mlp": {"MLP_0": "mlp"}, "linear": {"head": "head"}},
    },
    "dreamer_v2": {
        "world_model": {
            "mlp": {
                "mlp_encoder/MLP_0": "mlp_encoder.mlp",
                "rssm/recurrent_model/MLP_0": "rssm.recurrent_model.mlp",
                "rssm/representation_model/MLP_0": "rssm.representation_model.mlp",
                "rssm/transition_model/MLP_0": "rssm.transition_model.mlp",
                "mlp_decoder/MLP_0": "mlp_decoder.mlp",
                "reward_model/MLP_0": "reward_model.mlp",
                "continue_model/MLP_0": "continue_model.mlp",
            },
            "cnn": {"cnn_encoder/CNN_0": "cnn_encoder.cnn"},
            "decnn": {"cnn_decoder/DeCNN_0": "cnn_decoder.decnn"},
            "linear": {
                "rssm/representation_model/head": "rssm.representation_model.head",
                "rssm/transition_model/head": "rssm.transition_model.head",
                "cnn_decoder/Dense_0": "cnn_decoder.linear",
                "reward_model/head": "reward_model.head",
                "continue_model/head": "continue_model.head",
            },
            "keyed": ("mlp_decoder/head_", "mlp_decoder.heads."),
            "leaves": _GRU_LEAVES,
        },
        "actor": {"mlp": {"MLP_0": "mlp"}, "keyed": ("head_", "heads.")},
        "critic": {"mlp": {"MLP_0": "mlp"}, "linear": {"head": "head"}},
    },
    "dreamer_v3": {
        "world_model": {
            "mlp": {
                "encoder/mlp_encoder/MLP_0": "mlp_encoder.mlp",
                "rssm/recurrent_model/MLP_0": "rssm.recurrent_model.mlp",
                "rssm/transition_model/MLP_0": "rssm.transition_model.mlp",
                "mlp_decoder/MLP_0": "mlp_decoder.mlp",
                "reward_model/MLP_0": "reward_model.mlp",
                "continue_model/MLP_0": "continue_model.mlp",
            },
            "cnn": {"encoder/cnn_encoder/CNN_0": "cnn_encoder.cnn"},
            "decnn": {"cnn_decoder/DeCNN_0": "cnn_decoder.decnn", "cnn_decoder/head": "cnn_decoder.head"},
            "linear": {
                "rssm/representation_model/head": "rssm.representation_model.head",
                "rssm/transition_model/head": "rssm.transition_model.head",
                "cnn_decoder/Dense_0": "cnn_decoder.linear",
                "reward_model/head": "reward_model.head",
                "continue_model/head": "continue_model.head",
            },
            "keyed": ("mlp_decoder/head_", "mlp_decoder.heads."),
            "leaves": {
                **_GRU_LEAVES,
                f"{_REPR}/trunk_kernel": (f"{_TRUNK}.weight", _T),
                f"{_REPR}/trunk_bias": (f"{_TRUNK}.bias", _SAME),
                f"{_REPR}/trunk_ln/scale": (f"{_TRUNK}_ln.weight", _SAME),
                f"{_REPR}/trunk_ln/bias": (f"{_TRUNK}_ln.bias", _SAME),
                # the layout before the trunk was split (``migrate_dv3_checkpoint`` in the JAX package)
                f"{_REPR}/MLP_0/Dense_0/kernel": (f"{_TRUNK}.weight", _T),
                f"{_REPR}/MLP_0/Dense_0/bias": (f"{_TRUNK}.bias", _SAME),
                f"{_REPR}/MLP_0/LayerNorm_0/scale": (f"{_TRUNK}_ln.weight", _SAME),
                f"{_REPR}/MLP_0/LayerNorm_0/bias": (f"{_TRUNK}_ln.bias", _SAME),
            },
        },
        "actor": {"mlp": {"MLP_0": "mlp"}, "keyed": ("head_", "heads.")},
        "critic": {"mlp": {"MLP_0": "mlp"}, "linear": {"head": "head"}},
    },
}


#: Plan2Explore's ensemble (``p2e_dv3.agent.Ensemble``): stacked kernels keep their ``[N, in, out]`` layout
_ENSEMBLE_LAYOUT = {"mlp": {"MLP_0": "mlp"}, "linear": {"head": "head"}, "stacked": True}
for _family in _LAYOUTS.values():
    _family["ensembles"] = _ENSEMBLE_LAYOUT
#: a P2E tree → the layout it has; the task and exploration actors and critics are the family's own
_P2E_TREES = {
    "world_model": "world_model",
    "actor_task": "actor",
    "actor_exploration": "actor",
    "critic_task": "critic",
    "target_critic_task": "critic",
    "critic_exploration": "critic",
    "target_critic_exploration": "critic",
    "ensembles": "ensembles",
}
#: the trees a P2E training conversion must find
_P2E_REQUIRED = {
    "p2e_dv1": ("world_model", "actor_task", "critic_task", "actor_exploration", "critic_exploration", "ensembles"),
    "p2e_dv3": ("world_model", "actor_task", "critic_task", "target_critic_task", "actor_exploration",
                "critics_exploration", "ensembles"),
    "p2e_dv2": ("world_model", "actor_task", "critic_task", "target_critic_task", "actor_exploration",
                "critic_exploration", "target_critic_exploration", "ensembles"),
}


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            flat.update(_flatten(v, path + "/"))
        else:
            flat[path] = np.asarray(v)
    return flat


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C", copy=True))


def _layer_scope(flat, scope: str, layer: str) -> Dict[str, Dict[int, Dict[str, np.ndarray]]]:
    """``{layer kind: {index: {leaf: array}}}`` under ``scope``."""
    pat = re.compile(rf"^{re.escape(scope)}/({layer}|LayerNorm)_(\d+)/(\w+)$")
    out: Dict[str, Dict[int, Dict[str, np.ndarray]]] = {}
    for path, arr in flat.items():
        m = pat.match(path)
        if m:
            out.setdefault(m.group(1), {}).setdefault(int(m.group(2)), {})[m.group(3)] = arr
    return out


def _convert_stack(flat, scope, torch_scope, layer, block_fmt, norm_fmt, weight_fn, sd, used) -> None:
    found = _layer_scope(flat, scope, layer)
    layers, norms = found.get(layer, {}), found.get("LayerNorm", {})
    if norms and len(norms) != len(layers):
        raise ValueError(f"{scope}: LayerNorm on only some layers is not supported by the converter")
    for i, leaves in layers.items():
        for leaf, arr in leaves.items():
            key = block_fmt.format(scope=torch_scope, i=i)
            if leaf == "kernel":
                sd[f"{key}.weight"] = _t(weight_fn(arr))
            elif leaf == "bias":
                sd[f"{key}.bias"] = _t(arr)
            else:
                raise KeyError(f"unknown leaf {scope}/{layer}_{i}/{leaf}")
            used.add(f"{scope}/{layer}_{i}/{leaf}")
    for j, leaves in norms.items():
        for leaf, arr in leaves.items():
            name = {"scale": "weight", "bias": "bias"}.get(leaf)
            if name is None:
                raise KeyError(f"unknown leaf {scope}/LayerNorm_{j}/{leaf}")
            sd[f"{norm_fmt.format(scope=torch_scope, i=j)}.{name}"] = _t(arr)
            used.add(f"{scope}/LayerNorm_{j}/{leaf}")


def _convert_tree(
    family: str, name: str, flat: Dict[str, np.ndarray], training: bool
) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """One JAX tree of ``family`` → its ``state_dict`` and the paths it
    skipped. ``name`` is ``world_model``, ``actor`` or ``critic`` (the
    target critic's layout)."""
    layout = _LAYOUTS[family][name]
    skipped = [] if training else [p for p in flat if p.startswith(SKIPPED_PREFIXES.get(name, ()))]
    flat = {p: a for p, a in flat.items() if p not in set(skipped)}
    sd: Dict[str, torch.Tensor] = {}
    used: set = set()
    kernel_fn = _SAME if layout.get("stacked") else _T
    for scope, torch_scope in layout.get("mlp", {}).items():
        _convert_stack(
            flat, scope, torch_scope, "Dense", "{scope}.blocks.{i}.linear", "{scope}.blocks.{i}.norm", kernel_fn, sd,
            used,
        )
    for kind, layer in (("cnn", "Conv"), ("decnn", "ConvTranspose")):
        for scope, torch_scope in layout.get(kind, {}).items():
            _convert_stack(
                flat, scope, torch_scope, layer, "{scope}.convs.{i}", "{scope}.norms.{i}",
                lambda k: k.transpose(*_HWIO_TO_OIHW), sd, used,
            )
    linears = dict(layout.get("linear", {}))
    if "keyed" in layout:
        prefix, torch_prefix = layout["keyed"]
        linears.update(
            {p.rsplit("/", 1)[0]: torch_prefix + p.rsplit("/", 1)[0][len(prefix):] for p in flat if p.startswith(prefix)}
        )
    leaves = dict(layout.get("leaves", {}))
    for scope, torch_scope in linears.items():
        leaves[f"{scope}/kernel"] = (f"{torch_scope}.weight", kernel_fn)
        leaves[f"{scope}/bias"] = (f"{torch_scope}.bias", _SAME)
    for path, (key, fn) in leaves.items():
        if path in flat:
            sd[key] = _t(fn(flat[path]))
            used.add(path)
    unknown = sorted(set(flat) - used)
    if unknown:
        raise KeyError(f"convert_{family}: unknown {name} parameters {unknown}")
    return sd, [f"{name}/{p}" for p in sorted(skipped)]


def convert_layers(tree: Mapping[str, Any], kind: str) -> Dict[str, torch.Tensor]:
    """One flax module's params → the matching port module's ``state_dict``:
    ``kind`` is ``"mlp"`` (hidden layers only), ``"cnn"``, ``"decnn"``,
    ``"layer_norm"`` or ``"gru"`` (``LayerNormGRUCell``)."""
    flat = {f"m/{p}": a for p, a in _flatten(tree).items()}
    sd: Dict[str, torch.Tensor] = {}
    used: set = set()
    if kind == "mlp":
        _convert_stack(flat, "m", "", "Dense", "blocks.{i}.linear", "blocks.{i}.norm", lambda k: k.T, sd, used)
    elif kind == "cnn":
        _convert_stack(
            flat, "m", "", "Conv", "convs.{i}", "norms.{i}", lambda k: k.transpose(*_HWIO_TO_OIHW), sd, used
        )
    elif kind == "decnn":
        _convert_stack(
            flat, "m", "", "ConvTranspose", "convs.{i}", "norms.{i}", lambda k: k.transpose(*_HWIO_TO_OIHW), sd, used
        )
    elif kind == "layer_norm":
        sd = {"weight": _t(flat["m/scale"]), "bias": _t(flat["m/bias"])}
        used = {"m/scale", "m/bias"}
    elif kind == "gru":
        for path, key in (
            ("m/Dense_0/kernel", "weight"),
            ("m/Dense_0/bias", "bias"),
            ("m/LayerNorm_0/scale", "norm.weight"),
            ("m/LayerNorm_0/bias", "norm.bias"),
        ):
            if path in flat:
                sd[key] = _t(flat[path])
                used.add(path)
    else:
        raise ValueError(f"unknown module kind {kind!r}")
    unknown = sorted(set(flat) - used)
    if unknown:
        raise KeyError(f"convert_layers({kind}): unknown parameters {unknown}")
    return sd


def _convert(
    family: str, params: Mapping[str, Mapping[str, Any]], training: bool
) -> Tuple[Dict[str, Dict[str, torch.Tensor]], List[str]]:
    trees = _FAMILY_TREES.get(family, _TREES)
    state_dicts: Dict[str, Dict[str, torch.Tensor]] = {}
    skipped: List[str] = []
    for name, tree in params.items():
        if name not in trees:
            raise KeyError(f"convert_{family}: unknown param tree {name!r}")
        flat = _flatten(tree)
        if name in SKIPPED_TREES and not training:
            skipped += [f"{name}/{p}" for p in sorted(flat)]
            continue
        state_dicts[name], dropped = _convert_tree(family, "critic" if name == "target_critic" else name, flat, training)
        skipped += dropped
    for name in trees if training else ("world_model", "actor"):
        if name not in state_dicts:
            raise KeyError(f"convert_{family}: the {name!r} tree is missing")
    return state_dicts, skipped


def convert_dreamer_v1(
    params: Mapping[str, Mapping[str, Any]],
    training: bool = False,
) -> Tuple[Dict[str, Dict[str, torch.Tensor]], List[str]]:
    """JAX DV1 params (world model, actor, critic; no target critic) → the
    port's state dicts, as :func:`convert_dreamer_v2` does for DV2."""
    return _convert("dreamer_v1", params, training)


def convert_dreamer_v2(
    params: Mapping[str, Mapping[str, Any]],
    training: bool = False,
) -> Tuple[Dict[str, Dict[str, torch.Tensor]], List[str]]:
    """JAX DV2 params → ``({"world_model": state_dict, "actor": state_dict},
    skipped leaf paths)`` for a serving build, or with ``training=True``
    ``{"world_model", "actor", "critic", "target_critic"}`` state dicts for a
    training build (nothing skipped). Raises on a leaf it does not know."""
    return _convert("dreamer_v2", params, training)


def convert_dreamer_v3(
    params: Mapping[str, Mapping[str, Any]],
    training: bool = False,
) -> Tuple[Dict[str, Dict[str, torch.Tensor]], List[str]]:
    """JAX DV3 params (``agent.params`` of a checkpoint: world model, actor,
    critic, target critic) → the port's state dicts, as
    :func:`convert_dreamer_v2` does for DV2."""
    return _convert("dreamer_v3", params, training)


def _convert_p2e(
    algo: str, params: Mapping[str, Mapping[str, Any]], training: bool
) -> Tuple[Dict[str, Any], List[str]]:
    family = {"p2e_dv3": "dreamer_v3", "p2e_dv2": "dreamer_v2", "p2e_dv1": "dreamer_v1"}[algo]
    state_dicts: Dict[str, Any] = {}
    skipped: List[str] = []
    for name, tree in params.items():
        serving = name in ("world_model", "actor_task")
        if not training and not serving:
            skipped += [f"{name}/{p}" for p in sorted(_flatten(tree))]
            continue
        if name == "critics_exploration" and algo == "p2e_dv3":
            state_dicts[name] = {}
            for key, pair in tree.items():
                if set(pair) != {"module", "target"}:
                    raise KeyError(f"convert_{algo}: critics_exploration/{key} holds {sorted(pair)}, not module and target")
                state_dicts[name][key] = {
                    part: _convert_tree(family, "critic", _flatten(pair[part]), training)[0] for part in pair
                }
            continue
        if name not in _P2E_REQUIRED[algo]:
            raise KeyError(f"convert_{algo}: unknown param tree {name!r}")
        state_dicts[name], dropped = _convert_tree(family, _P2E_TREES[name], _flatten(tree), training)
        skipped += dropped
    for name in _P2E_REQUIRED[algo] if training else ("world_model", "actor_task"):
        if name not in state_dicts:
            raise KeyError(f"convert_{algo}: the {name!r} tree is missing")
    return state_dicts, skipped


def convert_p2e_dv3(
    params: Mapping[str, Mapping[str, Any]],
    training: bool = False,
) -> Tuple[Dict[str, Any], List[str]]:
    """JAX P2E-DV3 params (``agent.params`` of an exploration checkpoint:
    ``world_model``, ``actor_task``, ``critic_task``, ``target_critic_task``,
    ``actor_exploration``, ``critics_exploration.<name>.{module,target}``,
    ``ensembles``) → the port's state dicts under the same names
    (``critics_exploration`` a ``{name: {"module", "target"}}`` dict of
    them) for a training build; a serving one keeps ``world_model`` (without
    its training-only parts) and ``actor_task`` and lists every other leaf as
    skipped. Raises on a tree or a leaf it does not know."""
    return _convert_p2e("p2e_dv3", params, training)


def convert_p2e_dv2(
    params: Mapping[str, Mapping[str, Any]],
    training: bool = False,
) -> Tuple[Dict[str, Any], List[str]]:
    """JAX P2E-DV2 params (``world_model``, ``actor_task``, ``critic_task``,
    ``target_critic_task``, ``actor_exploration``, ``critic_exploration``,
    ``target_critic_exploration``, ``ensembles``) → the port's state dicts,
    as :func:`convert_p2e_dv3` does for P2E-DV3."""
    return _convert_p2e("p2e_dv2", params, training)


def convert_p2e_dv1(
    params: Mapping[str, Mapping[str, Any]],
    training: bool = False,
) -> Tuple[Dict[str, Any], List[str]]:
    """JAX P2E-DV1 params (``world_model``, ``actor_task``, ``critic_task``,
    ``actor_exploration``, ``critic_exploration``, ``ensembles``; no target
    critics) → the port's state dicts, as :func:`convert_p2e_dv3` does for
    P2E-DV3."""
    return _convert_p2e("p2e_dv1", params, training)

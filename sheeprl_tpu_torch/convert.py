"""Carry DreamerV2 weights across from the JAX package.

:func:`convert_dreamer_v2` turns the JAX package's DV2 param trees
(``{"world_model": ..., "actor": ...}`` as nested dicts of numpy arrays,
e.g. from ``jax.device_get``) into the port's ``state_dict``s:

- a Dense ``kernel [in, out]`` becomes a Linear ``weight [out, in]``;
- a Conv ``kernel`` HWIO becomes OIHW;
- a ``ConvTranspose`` kernel (``transpose_kernel=True``, stored as the HWIO
  kernel of the forward convolution it is the gradient of) becomes the
  ``ConvTranspose2d`` weight ``[in, out, kh, kw]`` by the same transpose,
  with no spatial flip;
- the GRU's joint ``Dense_0/kernel [H+X, 3H]`` stays as it is: it is the
  layout the CUDA kernel and the plain version both read;
- ``FastLayerNorm`` ``scale``/``bias`` become ``weight``/``bias``.

Every leaf is either consumed or listed as skipped. A training conversion
(``training=True``) consumes every leaf of the four trees; a serving one
skips the parts a serving build does not have (decoders, reward and
continue heads, critic, target critic). An unknown leaf raises.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

__all__ = ["SKIPPED_PREFIXES", "convert_dreamer_v2", "convert_layers"]

#: parameters of parts that training needs and serving does not (per tree)
SKIPPED_PREFIXES: Dict[str, Tuple[str, ...]] = {
    "world_model": ("cnn_decoder/", "mlp_decoder/", "reward_model/", "continue_model/"),
}
#: whole trees serving does not need
SKIPPED_TREES = ("critic", "target_critic")
_TREES = ("world_model", "actor", "critic", "target_critic")

# JAX module path → port module path, for the layer containers that hold
# Dense/Conv/LayerNorm leaves
_MLP_SCOPES = {
    "world_model": {
        "mlp_encoder/MLP_0": "mlp_encoder.mlp",
        "rssm/recurrent_model/MLP_0": "rssm.recurrent_model.mlp",
        "rssm/representation_model/MLP_0": "rssm.representation_model.mlp",
        "rssm/transition_model/MLP_0": "rssm.transition_model.mlp",
        "mlp_decoder/MLP_0": "mlp_decoder.mlp",
        "reward_model/MLP_0": "reward_model.mlp",
        "continue_model/MLP_0": "continue_model.mlp",
    },
    "actor": {"MLP_0": "mlp"},
    "critic": {"MLP_0": "mlp"},
}
_CNN_SCOPES = {"world_model": {"cnn_encoder/CNN_0": "cnn_encoder.cnn"}}
_DECNN_SCOPES = {"world_model": {"cnn_decoder/DeCNN_0": "cnn_decoder.decnn"}}
_LINEAR_LEAVES = {
    "world_model": {
        "rssm/representation_model/head": "rssm.representation_model.head",
        "rssm/transition_model/head": "rssm.transition_model.head",
        "cnn_decoder/Dense_0": "cnn_decoder.linear",
        "reward_model/head": "reward_model.head",
        "continue_model/head": "continue_model.head",
    },
    "critic": {"head": "head"},
}
#: per-key Linear heads: JAX ``<scope>/head_<key>`` → port ``<module>.<key>``
_KEYED_HEADS = {"world_model": ("mlp_decoder/head_", "mlp_decoder.heads."), "actor": ("head_", "heads.")}
_HWIO_TO_OIHW = (3, 2, 0, 1)
_GRU = "rssm/recurrent_model/gru"


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


def _convert_tree(name: str, flat: Dict[str, np.ndarray], training: bool) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """One JAX tree → its ``state_dict`` and the paths it skipped. ``name``
    is ``world_model``, ``actor`` or ``critic`` (the target critic's layout)."""
    skipped = [] if training else [p for p in flat if p.startswith(SKIPPED_PREFIXES.get(name, ()))]
    flat = {p: a for p, a in flat.items() if p not in set(skipped)}
    sd: Dict[str, torch.Tensor] = {}
    used: set = set()
    for scope, torch_scope in _MLP_SCOPES.get(name, {}).items():
        _convert_stack(
            flat, scope, torch_scope, "Dense", "{scope}.blocks.{i}.linear", "{scope}.blocks.{i}.norm",
            lambda k: k.T, sd, used,
        )
    for scopes, layer in ((_CNN_SCOPES, "Conv"), (_DECNN_SCOPES, "ConvTranspose")):
        for scope, torch_scope in scopes.get(name, {}).items():
            _convert_stack(
                flat, scope, torch_scope, layer, "{scope}.convs.{i}", "{scope}.norms.{i}",
                lambda k: k.transpose(*_HWIO_TO_OIHW), sd, used,
            )
    linears = dict(_LINEAR_LEAVES.get(name, {}))
    if name in _KEYED_HEADS:
        prefix, torch_prefix = _KEYED_HEADS[name]
        linears.update(
            {p.rsplit("/", 1)[0]: torch_prefix + p.rsplit("/", 1)[0][len(prefix):] for p in flat if p.startswith(prefix)}
        )
    for scope, torch_scope in linears.items():
        for leaf, torch_leaf, fn in (("kernel", "weight", lambda k: k.T), ("bias", "bias", lambda b: b)):
            path = f"{scope}/{leaf}"
            if path in flat:
                sd[f"{torch_scope}.{torch_leaf}"] = _t(fn(flat[path]))
                used.add(path)
    if name == "world_model":
        for path, key in (
            (f"{_GRU}/Dense_0/kernel", "rssm.recurrent_model.gru.weight"),
            (f"{_GRU}/Dense_0/bias", "rssm.recurrent_model.gru.bias"),
            (f"{_GRU}/LayerNorm_0/scale", "rssm.recurrent_model.gru.norm.weight"),
            (f"{_GRU}/LayerNorm_0/bias", "rssm.recurrent_model.gru.norm.bias"),
        ):
            if path in flat:
                sd[key] = _t(flat[path])
                used.add(path)
    unknown = sorted(set(flat) - used)
    if unknown:
        raise KeyError(f"convert_dreamer_v2: unknown {name} parameters {unknown}")
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


def convert_dreamer_v2(
    params: Mapping[str, Mapping[str, Any]],
    training: bool = False,
) -> Tuple[Dict[str, Dict[str, torch.Tensor]], List[str]]:
    """JAX DV2 params → ``({"world_model": state_dict, "actor": state_dict},
    skipped leaf paths)`` for a serving build, or with ``training=True``
    ``{"world_model", "actor", "critic", "target_critic"}`` state dicts for a
    training build (nothing skipped). Raises on a leaf it does not know."""
    state_dicts: Dict[str, Dict[str, torch.Tensor]] = {}
    skipped: List[str] = []
    for name, tree in params.items():
        if name not in _TREES:
            raise KeyError(f"convert_dreamer_v2: unknown param tree {name!r}")
        flat = _flatten(tree)
        if name in SKIPPED_TREES and not training:
            skipped += [f"{name}/{p}" for p in sorted(flat)]
            continue
        state_dicts[name], dropped = _convert_tree("critic" if name == "target_critic" else name, flat, training)
        skipped += dropped
    for name in _TREES if training else ("world_model", "actor"):
        if name not in state_dicts:
            raise KeyError(f"convert_dreamer_v2: the {name!r} tree is missing")
    return state_dicts, skipped

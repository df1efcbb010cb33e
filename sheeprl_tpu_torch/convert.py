"""Carry DreamerV1, DreamerV2, DreamerV3, the SAC family's and the
on-policy family's weights across from the JAX package.

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

The SAC family (:func:`convert_sac`, :func:`convert_droq`,
:func:`convert_sac_ae`) converts each agent tree by its own rules: the
critics' stacked kernels ``[N, in, out]`` keep their layout, SAC-AE's
convolutions and transposed convolutions are transposed as above and its
projection is flattened NHWC as the Dreamer CNNs are; ``log_alpha`` is one
leaf.

The on-policy family (:func:`convert_ppo` for PPO and A2C,
:func:`convert_ppo_recurrent`) converts the whole agent (the NatureCNN as
SAC-AE's encoder, the MLPs with a head, the LSTM's eight leaves), and
:func:`convert_optax_state` carries an optax state (the learning rate,
Adam's moments or SGD's trace) into the port optimizer's, so that a JAX
checkpoint resumes in the port.

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
    "convert_optax_state",
    "convert_p2e_dv1",
    "convert_p2e_dv2",
    "convert_p2e_dv3",
    "convert_critic_ensemble",
    "convert_droq",
    "convert_ppo",
    "convert_ppo_recurrent",
    "convert_sac",
    "convert_sac_actor",
    "convert_sac_ae",
    "convert_sac_ae_actor",
    "convert_sac_ae_decoder",
    "convert_sac_ae_encoder",
    "onpolicy_converter",
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


# ---------------------------------------------------------------------------
# the SAC family: SAC, DroQ, SAC-AE
# ---------------------------------------------------------------------------


def _by_rules(flat: Dict[str, np.ndarray], rules, where: str) -> Dict[str, torch.Tensor]:
    """``flat`` (``scope/leaf`` paths) → a ``state_dict`` by ``rules``, each
    ``(regex, key template over its groups, transform)``; every leaf must
    match one rule."""
    sd: Dict[str, torch.Tensor] = {}
    for path, arr in flat.items():
        for pattern, template, fn in rules:
            m = re.fullmatch(pattern, path)
            if m:
                sd[template.format(*m.groups())] = _t(fn(arr))
                break
        else:
            raise KeyError(f"{where}: unknown parameter {path}")
    return sd


def _dense(scope: str, module: str, fn=_T):
    return [(rf"{scope}/kernel", f"{module}.weight", fn), (rf"{scope}/bias", f"{module}.bias", _SAME)]


def _mlp_rules(scope: str, module: str):
    return [
        (rf"{scope}/Dense_(\d+)/kernel", module + ".blocks.{0}.linear.weight", _T),
        (rf"{scope}/Dense_(\d+)/bias", module + ".blocks.{0}.linear.bias", _SAME),
        (rf"{scope}/LayerNorm_(\d+)/scale", module + ".blocks.{0}.norm.weight", _SAME),
        (rf"{scope}/LayerNorm_(\d+)/bias", module + ".blocks.{0}.norm.bias", _SAME),
    ]


def convert_sac_actor(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX ``SACActor`` (``MLP_0``, the mean ``Dense_0``, the log-std
    ``Dense_1``) → :class:`~sheeprl_tpu_torch.algos.sac.agent.SACActor`'s ``state_dict``."""
    rules = _mlp_rules("MLP_0", "mlp") + _dense("Dense_0", "mean") + _dense("Dense_1", "log_std")
    return _by_rules(_flatten(tree), rules, "convert_sac_actor")


def convert_critic_ensemble(tree: Mapping[str, Any], head: str = "last") -> Dict[str, torch.Tensor]:
    """A stacked JAX critic (leaves ``[N, ...]``) →
    :class:`~sheeprl_tpu_torch.algos.sac.agent.CriticEnsemble`'s ``state_dict``,
    the kernels keeping their ``[N, in, out]`` layout. The head is the
    ``MLP_0``'s last Dense (``head="last"``: SAC's and DroQ's ``SACCritic``,
    whose MLP has ``output_dim``) or a ``Dense_0`` beside it (``"dense"``:
    SAC-AE's ``SACAEQFunction``)."""
    flat = _flatten(tree)
    if head == "last":
        last = max(int(m.group(1)) for p in flat if (m := re.fullmatch(r"MLP_0/Dense_(\d+)/kernel", p)))
        head_rules = _dense(f"MLP_0/Dense_{last}", "head", _SAME)
    else:
        head_rules = _dense("Dense_0", "head", _SAME)
    rules = head_rules + [
        (r"MLP_0/Dense_(\d+)/kernel", "blocks.{0}.linear.weight", _SAME),
        (r"MLP_0/Dense_(\d+)/bias", "blocks.{0}.linear.bias", _SAME),
        (r"MLP_0/LayerNorm_(\d+)/scale", "blocks.{0}.norm.weight", _SAME),
        (r"MLP_0/LayerNorm_(\d+)/bias", "blocks.{0}.norm.bias", _SAME),
    ]
    return _by_rules(flat, rules, "convert_critic_ensemble")


def _convert_sac_trees(params: Mapping[str, Any], training: bool, head: str, trees) -> Tuple[Dict[str, Any], List[str]]:
    out: Dict[str, Any] = {}
    skipped: List[str] = []
    for name, tree in params.items():
        if name not in trees:
            raise KeyError(f"convert: unknown param tree {name!r}")
        if not training and name != "actor":
            skipped += [name] if name == "log_alpha" else [f"{name}/{p}" for p in sorted(_flatten(tree))]
            continue
        if name == "actor":
            out[name] = convert_sac_actor(tree)
        elif name == "log_alpha":
            out[name] = _t(np.asarray(tree))
        else:
            out[name] = convert_critic_ensemble(tree, head)
    for name in trees if training else ("actor",):
        if name not in out:
            raise KeyError(f"convert: the {name!r} tree is missing")
    return out, skipped


_SAC_TREES = ("actor", "critics", "target_critics", "log_alpha")


def convert_sac(params: Mapping[str, Any], training: bool = False) -> Tuple[Dict[str, Any], List[str]]:
    """A JAX SAC (or DroQ) agent tree (``actor``, ``critics``,
    ``target_critics``, ``log_alpha``) → the port's: a serving conversion
    keeps the actor and lists every other leaf as skipped; a training one
    converts all four (the critics' LayerNorms too, DroQ's)."""
    return _convert_sac_trees(params, training, "last", _SAC_TREES)


convert_droq = convert_sac


def convert_sac_ae_encoder(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX ``SACAEEncoder`` → the port's ``SACAEEncoder`` ``state_dict``:
    the convolutions HWIO → OIHW, the projection's Dense and LayerNorm, the
    MLP encoder's layers."""
    rules = [
        (r"cnn_encoder/Conv_(\d+)/kernel", "cnn_encoder.cnn.convs.{0}.weight", lambda k: k.transpose(*_HWIO_TO_OIHW)),
        (r"cnn_encoder/Conv_(\d+)/bias", "cnn_encoder.cnn.convs.{0}.bias", _SAME),
        *_dense("cnn_encoder/Dense_0", "cnn_encoder.fc"),
        (r"cnn_encoder/LayerNorm_0/scale", "cnn_encoder.norm.weight", _SAME),
        (r"cnn_encoder/LayerNorm_0/bias", "cnn_encoder.norm.bias", _SAME),
        *_mlp_rules("mlp_encoder/MLP_0", "mlp_encoder.mlp"),
    ]
    return _by_rules(_flatten(tree), rules, "convert_sac_ae_encoder")


def convert_sac_ae_decoder(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX ``SACAEDecoder`` → the port's: the Dense back to the map, the
    transposed convolutions by the same transpose (no flip), the MLP
    decoder's trunk and per-key heads."""
    rules = [
        *_dense("cnn_decoder/Dense_0", "cnn_decoder.fc"),
        (r"cnn_decoder/ConvTranspose_(\d+)/kernel", "cnn_decoder.deconvs.{0}.weight",
         lambda k: k.transpose(*_HWIO_TO_OIHW)),
        (r"cnn_decoder/ConvTranspose_(\d+)/bias", "cnn_decoder.deconvs.{0}.bias", _SAME),
        *_mlp_rules("mlp_decoder/MLP_0", "mlp_decoder.mlp"),
        (r"mlp_decoder/head_(\w+)/kernel", "mlp_decoder.heads.{0}.weight", _T),
        (r"mlp_decoder/head_(\w+)/bias", "mlp_decoder.heads.{0}.bias", _SAME),
    ]
    return _by_rules(_flatten(tree), rules, "convert_sac_ae_decoder")


def convert_sac_ae_actor(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX ``SACAEActorTrunk`` → the port's ``SACAEActor``."""
    rules = _mlp_rules("MLP_0", "mlp") + _dense("fc_mean", "fc_mean") + _dense("fc_logstd", "fc_logstd")
    return _by_rules(_flatten(tree), rules, "convert_sac_ae_actor")


_SAC_AE_TREES = ("encoder", "target_encoder", "qfs", "target_qfs", "actor", "decoder", "log_alpha")


def convert_sac_ae(params: Mapping[str, Any], training: bool = False) -> Tuple[Dict[str, Any], List[str]]:
    """A JAX SAC-AE agent tree → the port's state dicts under the same names:
    a serving conversion keeps ``encoder`` and ``actor`` and lists every
    other leaf as skipped; a training one converts all seven."""
    out: Dict[str, Any] = {}
    skipped: List[str] = []
    convert_tree = {
        "encoder": convert_sac_ae_encoder, "target_encoder": convert_sac_ae_encoder,
        "qfs": lambda t: convert_critic_ensemble(t, "dense"), "target_qfs": lambda t: convert_critic_ensemble(t, "dense"),
        "actor": convert_sac_ae_actor, "decoder": convert_sac_ae_decoder, "log_alpha": lambda t: _t(np.asarray(t)),
    }
    for name, tree in params.items():
        if name not in convert_tree:
            raise KeyError(f"convert_sac_ae: unknown param tree {name!r}")
        if not training and name not in ("encoder", "actor"):
            skipped += [name] if name == "log_alpha" else [f"{name}/{p}" for p in sorted(_flatten(tree))]
            continue
        out[name] = convert_tree[name](tree)
    for name in _SAC_AE_TREES if training else ("encoder", "actor"):
        if name not in out:
            raise KeyError(f"convert_sac_ae: the {name!r} tree is missing")
    return out, skipped


# ---------------------------------------------------------------------------
# the on-policy family: PPO, A2C, PPO-recurrent
# ---------------------------------------------------------------------------


def _last_dense(flat: Mapping[str, np.ndarray], scope: str) -> int:
    found = [int(m.group(1)) for p in flat if (m := re.fullmatch(rf"{re.escape(scope)}/Dense_(\d+)/kernel", p))]
    if not found:
        raise KeyError(f"no Dense layer under {scope}")
    return max(found)


def _head_mlp_rules(flat, scope: str, module: str):
    """The JAX ``MLP`` with ``output_dim`` → :class:`~sheeprl_tpu_torch.algos.ppo.agent.MLPHead`:
    its last Dense is ``head``, the others (and their LayerNorms) ``mlp``'s blocks."""
    return _dense(f"{scope}/Dense_{_last_dense(flat, scope)}", f"{module}.head") + _mlp_rules(scope, f"{module}.mlp")


def _ppo_rules(flat: Mapping[str, np.ndarray]):
    rules = [
        (r"cnn_encoder/Conv_(\d+)/kernel", "encoder.cnn_encoder.cnn.convs.{0}.weight",
         lambda k: k.transpose(*_HWIO_TO_OIHW)),
        (r"cnn_encoder/Conv_(\d+)/bias", "encoder.cnn_encoder.cnn.convs.{0}.bias", _SAME),
        *_dense("cnn_encoder/Dense_0", "encoder.cnn_encoder.fc"),
        *_mlp_rules("actor_backbone", "actor_backbone"),
        (r"actor_heads_(\d+)/kernel", "actor_heads.{0}.weight", _T),
        (r"actor_heads_(\d+)/bias", "actor_heads.{0}.bias", _SAME),
        *_mlp_rules("pre_rnn", "pre_rnn"),
        *_mlp_rules("post_rnn", "post_rnn"),
        (r"rnn/OptimizedLSTMCell_0/(\w+)/kernel", "rnn.cell.{0}.weight", _T),
        (r"rnn/OptimizedLSTMCell_0/(\w+)/bias", "rnn.cell.{0}.bias", _SAME),
    ]
    for scope, module in (("mlp_encoder", "encoder.mlp_encoder"), ("critic", "critic")):
        if any(p.startswith(scope + "/") for p in flat):
            rules = _head_mlp_rules(flat, scope, module) + rules
    return rules


def convert_ppo(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX ``PPOAgent`` param tree (PPO's and A2C's) →
    :class:`~sheeprl_tpu_torch.algos.ppo.agent.PPOAgent`'s ``state_dict``:
    Dense kernels transposed, convolutions HWIO → OIHW (the projection after
    them reads the NHWC flatten, as the port's CNN gives it), the MLPs with a
    head (``mlp_encoder``, ``critic``) split into blocks and ``head``, one
    Linear per actor head. Every leaf is converted (serving needs the whole
    agent: the critic is a few kernels)."""
    flat = _flatten(params)
    return _by_rules(flat, _ppo_rules(flat), "convert_ppo")


def convert_ppo_recurrent(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX ``RecurrentPPOAgent`` param tree → the port's
    :class:`~sheeprl_tpu_torch.algos.ppo_recurrent.agent.RecurrentPPOAgent`:
    PPO's rules, the pre- and post-RNN MLPs', and the LSTM's eight leaves
    (``OptimizedLSTMCell_0/{ii,if,ig,io}`` kernels, ``{hi,hf,hg,ho}`` kernels
    and biases), each the Linear of the same name in ``models.LSTMCell``,
    transposed."""
    return convert_ppo(params)


def onpolicy_converter(algo: str):
    """``algo``'s param-tree converter: ``convert_ppo_recurrent`` for
    ``ppo_recurrent``, ``convert_ppo`` for ``ppo``, ``ppo_decoupled`` and
    ``a2c``."""
    if algo == "ppo_recurrent":
        return convert_ppo_recurrent
    if algo in ("ppo", "ppo_decoupled", "a2c"):
        return convert_ppo
    raise KeyError(f"no on-policy converter for {algo!r}")


def _fields(tree: Any) -> Any:
    """A tree with its NamedTuples (optax's live states) as field dicts, as a
    checkpoint restores them."""
    if hasattr(tree, "_asdict"):
        return {k: _fields(v) for k, v in tree._asdict().items()}
    if isinstance(tree, Mapping):
        return {k: _fields(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_fields(v) for v in tree]
    return tree


def _find(tree: Any, pred) -> Any:
    """The first node of a nested dict/list/tuple tree for which ``pred`` holds."""
    if pred(tree):
        return tree
    children = tree.values() if isinstance(tree, Mapping) else tree if isinstance(tree, (list, tuple)) else ()
    for child in children:
        found = _find(child, pred)
        if found is not None:
            return found
    return None


def convert_optax_state(opt_state: Any, convert_params, names) -> Dict[str, Any]:
    """A JAX optimizer state (``utils/optim.py``'s factories: an
    ``inject_hyperparams`` state, behind a ``clip_by_global_norm`` or an
    ``add_decayed_weights`` in a chain, as a checkpoint restores it: field
    dicts) → the port optimizer's ``{"state": {index: {...}}, "lr": float}``
    over the parameter ``names`` (the port module's ``named_parameters``
    order): Adam's ``mu``, ``nu`` and ``count`` as ``exp_avg``,
    ``exp_avg_sq`` and ``step``, SGD's ``trace`` as ``momentum_buffer``, each
    tree converted like the params by ``convert_params``. An SGD without
    momentum has no per-parameter state. A live optax state (NamedTuples)
    converts the same."""
    opt_state = _fields(opt_state)
    injected = _find(opt_state, lambda t: isinstance(t, Mapping) and "hyperparams" in t)
    if injected is None:
        raise KeyError("the optimizer state holds no injected learning rate (optax.inject_hyperparams)")
    lr = float(np.asarray(injected["hyperparams"]["learning_rate"]))
    inner = injected.get("inner_state", ())
    adam = _find(inner, lambda t: isinstance(t, Mapping) and "mu" in t and "nu" in t)
    trace = _find(inner, lambda t: isinstance(t, Mapping) and "trace" in t)
    state: Dict[int, Dict[str, torch.Tensor]] = {}
    if adam is not None:
        mu, nu = convert_params(adam["mu"]), convert_params(adam["nu"])
        count = torch.tensor(float(np.asarray(adam["count"])), dtype=torch.float32)
        for i, name in enumerate(names):
            state[i] = {"step": count.clone(), "exp_avg": mu[name], "exp_avg_sq": nu[name]}
    elif trace is not None:
        buffers = convert_params(trace["trace"])
        for i, name in enumerate(names):
            state[i] = {"momentum_buffer": buffers[name]}
    return {"state": state, "lr": lr}

"""The port's building blocks against their flax counterparts after
``convert_layers``: FastLayerNorm, MLP, CNN (NHWC flatten order), DeCNN
(``transpose_kernel=True``, torch-style padding) and LayerNormGRUCell.
Inputs and weights come from numpy seeds.

Tolerance: rtol/atol 2e-5 (float32 on the CPU, different summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.models import CNN as JaxCNN
from sheeprl_tpu.models import DeCNN as JaxDeCNN
from sheeprl_tpu.models import MLP as JaxMLP
from sheeprl_tpu.models import LayerNormGRUCell as JaxCell
from sheeprl_tpu.models.norm import FastLayerNorm as JaxLN
from sheeprl_tpu_torch.convert import convert_layers
from sheeprl_tpu_torch.models import CNN, MLP, DeCNN, FastLayerNorm, LayerNormGRUCell

TOL = dict(rtol=2e-5, atol=2e-5)


def _randomize(params, seed):
    """Replace every leaf by seeded numpy noise (LayerNorm scales near 1)."""
    rng = np.random.RandomState(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    leaves = []
    for path, leaf in flat:
        noise = rng.randn(*leaf.shape).astype(np.float32)
        name = path[-1].key
        leaves.append(1.0 + 0.1 * noise if name == "scale" else 0.3 * noise)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _init(module, *inputs, seed=0):
    params = module.init(jax.random.PRNGKey(0), *[jnp.asarray(i) for i in inputs])["params"]
    return _randomize(params, seed)


@pytest.mark.parametrize("eps", [1e-5, 1e-3])
def test_fast_layer_norm(eps):
    x = np.random.RandomState(1).randn(5, 37).astype(np.float32) * 3 + 1
    jm = JaxLN(epsilon=eps)
    params = _init(jm, x)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = FastLayerNorm(37, eps=eps)
    tm.load_state_dict(convert_layers(params, "layer_norm"))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("layer_norm", [False, True])
@pytest.mark.parametrize("activation", ["elu", "silu"])
def test_mlp(layer_norm, activation):
    x = np.random.RandomState(2).randn(4, 13).astype(np.float32)
    jm = JaxMLP(hidden_sizes=[16, 8], activation=activation, layer_norm=layer_norm)
    params = _init(jm, x, seed=3)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = MLP(13, [16, 8], activation=activation, layer_norm=layer_norm)
    tm.load_state_dict(convert_layers(params, "mlp"))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("layer_norm", [False, True])
def test_cnn_flattens_in_nhwc_order(layer_norm):
    x = np.random.RandomState(4).randn(2, 3, 3, 32, 32).astype(np.float32)
    kw = dict(kernel_sizes=4, strides=2, paddings=0, activation="elu", layer_norm=layer_norm, flatten=True)
    jm = JaxCNN(channels=[4, 8], **kw)
    params = _init(jm, x, seed=5)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = CNN(3, [4, 8], **kw)
    tm.load_state_dict(convert_layers(params, "cnn"))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 3, 8 * 6 * 6)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("padding", [0, 1])
@pytest.mark.parametrize("kernel", [5, 6])
def test_decnn_layer_matches_flax(kernel, padding):
    """A transposed or unflipped kernel keeps every shape and shows only as
    wrong pixels, so this compares values: one stride-2 layer at the
    decoder's kernel sizes, non-square input, random (not symmetric) weights."""
    x = np.random.RandomState(8 + kernel).randn(2, 5, 3, 4).astype(np.float32)
    kw = dict(kernel_sizes=kernel, strides=2, paddings=padding, activation="elu")
    jm = JaxDeCNN(channels=[7], **kw)
    params = _init(jm, x, seed=9)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = DeCNN(5, [7], **kw)
    tm.load_state_dict(convert_layers(params, "decnn"))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 7, 2 * 2 + kernel - 2 * padding, 3 * 2 + kernel - 2 * padding)
    np.testing.assert_allclose(got, want, **TOL)


def test_decnn_stack_matches_flax():
    """The decoder's stack from a 1x1 map: k=5,5,6,6, s=2, activation between
    layers only."""
    x = np.random.RandomState(10).randn(3, 12, 1, 1).astype(np.float32)
    kw = dict(kernel_sizes=[5, 5, 6, 6], strides=2, paddings=0, activation="elu")
    jm = JaxDeCNN(channels=[8, 4, 2, 3], **kw)
    params = _init(jm, x, seed=11)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = DeCNN(12, [8, 4, 2, 3], **kw)
    tm.load_state_dict(convert_layers(params, "decnn"))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 3, 64, 64)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("bias,layer_norm,eps", [(True, True, 1e-5), (False, True, 1e-3), (True, False, 1e-3)])
def test_layer_norm_gru_cell(bias, layer_norm, eps):
    rng = np.random.RandomState(6)
    x = rng.randn(3, 10).astype(np.float32)
    h = rng.randn(3, 12).astype(np.float32)
    jm = JaxCell(12, bias=bias, layer_norm=layer_norm, norm_eps=eps)
    params = _init(jm, x, h, seed=7)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(h)))
    tm = LayerNormGRUCell(10, 12, bias=bias, layer_norm=layer_norm, norm_eps=eps)
    sd = convert_layers(params, "gru")
    assert tuple(sd["weight"].shape) == (22, 36)  # [H+X, 3H], h rows first, as JAX keeps it
    tm.load_state_dict(sd)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x), torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_convert_layers_rejects_unknown_leaves():
    with pytest.raises(KeyError, match="unknown"):
        convert_layers({"Dense_0": {"kernel": np.zeros((2, 3)), "scale": np.zeros(3)}}, "mlp")

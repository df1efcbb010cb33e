"""``fabric.precision=bf16-mixed`` in the port against the JAX package on the CPU.

The JAX meaning: parameters stay f32, activations compute in bf16 through
each module's ``dtype``, every head is cast back to f32, the recurrent
model's new h is f32 (``sheeprl_tpu/fabric.py``, ``models/norm.py``,
``algos/dreamer_v3/agent.py``). Inputs are made with numpy from a seed and
handed to both sides; a DreamerV3 step gets the JAX step's own noise, as in
``test_torch_dreamer_v3_train.py``.

Tolerances. bf16 keeps 8 significant bits: one rounding to nearest moves a
value by up to 2^-8 of it (``BF16 = 2**-8``), so a value rounded on one side
and not, or at another place, on the other is up to 2^-8 apart, relative:

- the plain bf16 cell against the Pallas cell with bf16 operands (interpret
  mode): both round h, x and W to bf16 and accumulate in f32, so only the
  f32 summation order differs: rtol/atol 2e-5, the f32 kernel suite's;
- against JAX's ``LayerNormGRUCell(dtype=bf16)`` on the reference tier,
  which also rounds z, the LayerNorm's output and the gates to bf16: atol
  4·2^-8 on gate outputs of magnitude up to 1;
- ``FastLayerNorm(dtype=bf16)``: the same f32 statistics and one rounding
  of the output on each side: rtol 2^-8;
- the bf16 cell's hand VJP against autograd of the plain bf16 cell: the same
  rounded operands, f32 arithmetic: rtol 1e-4, atol 1e-5;
- a whole DreamerV3 step: the port's cell keeps z, the LayerNorm and the
  gates in f32 where JAX's reference cell rounds them (the Pallas kernel's
  meaning against flax's), and every layer's output is a bf16 rounding on
  both sides, so each value carries a few 2^-8 of relative difference, and
  a categorical sample whose two best scores lie within that of each other
  can go either way. Losses and metrics: rtol 16·2^-8 (6%), atol 16·2^-8 ·
  0.1; gradients per module (the optimizers' first moments): atol 16·2^-8
  of each gradient's largest magnitude; parameters after the Adam step:
  the first Adam step moves each parameter by ``lr·sign(g)``, so where a
  gradient is within that tolerance of zero bf16 rounding can flip its sign
  and the parameter differs by ``2·lr``; elsewhere atol 2% of the learning
  rate, as the f32 test's.
"""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v3 import agent as jax_agent
from sheeprl_tpu.algos.dreamer_v3 import dreamer_v3 as jax_dv3
from sheeprl_tpu.config import compose
from sheeprl_tpu.fabric import Fabric as JaxFabric
from sheeprl_tpu.kernels import pallas_tpu
from sheeprl_tpu.models.models import LayerNormGRUCell as JaxCell
from sheeprl_tpu.models.norm import FastLayerNorm as JaxFastLayerNorm
from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_agent as build_dv2_agent
from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import build_optimizers_and_state, build_train_fn
from sheeprl_tpu_torch.configs import dreamer_v2_config, dreamer_v3_config
from sheeprl_tpu_torch.convert import convert_dreamer_v3
from sheeprl_tpu_torch.fabric import Fabric
from sheeprl_tpu_torch.kernels import ops, reference
from sheeprl_tpu_torch.models.norm import FastLayerNorm
from test_torch_dreamer_v3_train import ACTIONS, MODULES, SMALL, _batch, _first_moments, _jax_noise

BF16 = 2.0**-8
CELL_TOL = dict(rtol=2e-5, atol=2e-5)
STEP_METRIC_TOL = dict(rtol=16 * BF16, atol=16 * BF16 * 0.1)
STEP_GRAD_ATOL_OF_MAX = 16 * BF16
LR = 8e-5  # the smallest learning rate of the preset's three optimizers
BF16_OVERRIDES = {**SMALL, "fabric.precision": "bf16-mixed"}


def test_fabric_precision_dtypes():
    """As ``tests/test_runtime/test_fabric.py`` holds the JAX Fabric."""
    assert Fabric(accelerator="cpu").compute_dtype is None
    assert Fabric(accelerator="cpu", precision="bf16-mixed").compute_dtype == torch.bfloat16
    assert Fabric(accelerator="cpu", precision="bf16-mixed").param_dtype == torch.float32
    assert JaxFabric(devices=1, accelerator="cpu", precision="bf16-mixed").compute_dtype == jnp.bfloat16
    with pytest.raises(ValueError):
        Fabric(accelerator="cpu", precision="16-mixed")


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_fast_layer_norm_bf16_matches_jax(in_dtype):
    rng = np.random.RandomState(0)
    x = (3.0 * rng.randn(5, 48) + 1.0).astype(np.float32)
    scale = (1.0 + 0.1 * rng.randn(48)).astype(np.float32)
    bias = (0.1 * rng.randn(48)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.dtype(in_dtype))
    want = JaxFastLayerNorm(epsilon=1e-3, dtype=jnp.bfloat16).apply({"params": {"scale": scale, "bias": bias}}, jx)
    ln = FastLayerNorm(48, eps=1e-3, dtype=torch.bfloat16)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
        got = ln(torch.from_numpy(x).to(getattr(torch, in_dtype)))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert ln.weight.dtype == torch.float32
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), rtol=BF16, atol=0)


def _cell_operands(B, H, X, seed):
    """f32 operands whose h is already bf16-exact, so that the Pallas cell
    (which mixes its bf16 h into the gates) and the port's (which mixes the
    f32 h) see the same h."""
    rng = np.random.RandomState(seed)
    h = np.asarray(jnp.asarray(rng.randn(B, H).astype(np.float32)).astype(jnp.bfloat16).astype(jnp.float32))
    x = rng.randn(B, X).astype(np.float32)
    w = (rng.randn(H + X, 3 * H) / np.sqrt(H + X)).astype(np.float32)
    s = (1.0 + 0.1 * rng.randn(3 * H)).astype(np.float32)
    lb = (0.1 * rng.randn(3 * H)).astype(np.float32)
    return h, x, w, s, lb


@pytest.mark.parametrize("B,H,X", [(4, 64, 48), (7, 37, 20)])
def test_plain_bf16_cell_matches_pallas_bf16_interpret(B, H, X):
    h, x, w, s, lb = _cell_operands(B, H, X, seed=B + H)
    bf = jnp.bfloat16
    want = pallas_tpu.hafner_cell(
        jnp.asarray(h).astype(bf), jnp.asarray(x).astype(bf), jnp.asarray(w).astype(bf), None, jnp.asarray(s),
        jnp.asarray(lb), hidden_size=H, eps=1e-3, layer_norm=True, interpret=True,
    )
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = reference.hafner_cell(torch.from_numpy(h), xt, torch.from_numpy(w), None, torch.from_numpy(s),
                                torch.from_numpy(lb), eps=1e-3)
    with torch.inference_mode():  # the wrapper's CPU path is the plain version
        wrapped = ops.hafner_gru_cell(torch.from_numpy(h), xt, torch.from_numpy(w), None, torch.from_numpy(s),
                                      torch.from_numpy(lb), eps=1e-3)
    assert got.dtype == torch.float32 and wrapped.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), **CELL_TOL)
    np.testing.assert_array_equal(wrapped.numpy(), got.numpy())


def test_plain_bf16_cell_matches_jax_reference_cell_at_bf16():
    B, H, X = 6, 48, 32
    h, x, w, s, lb = _cell_operands(B, H, X, seed=3)
    cell = JaxCell(H, bias=False, layer_norm=True, norm_eps=1e-3, dtype=jnp.bfloat16)
    params = {"Dense_0": {"kernel": w}, "LayerNorm_0": {"scale": s, "bias": lb}}
    want = cell.apply({"params": params}, jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(h))
    got = reference.hafner_cell(torch.from_numpy(h), torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w),
                                None, torch.from_numpy(s), torch.from_numpy(lb), eps=1e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), rtol=0, atol=4 * BF16)


def test_bf16_cell_vjp_matches_autograd_of_plain_cell():
    """The hand VJP at the kept f32 z against autograd through the plain
    bf16 cell's roundings (an ``astype``'s gradient is the identity): dx
    comes back bf16, dh and the parameters' gradients f32."""
    B, H, X = 5, 32, 24
    h, x, w, s, lb = _cell_operands(B, H, X, seed=9)
    g = np.random.RandomState(10).randn(B, H).astype(np.float32)

    def leaves():
        return [torch.from_numpy(h).requires_grad_(), torch.from_numpy(x).to(torch.bfloat16).requires_grad_(),
                torch.from_numpy(w).requires_grad_(), torch.from_numpy(s).requires_grad_(),
                torch.from_numpy(lb).requires_grad_()]

    a = leaves()
    out = ops.hafner_gru_cell(a[0], a[1], a[2], None, a[3], a[4], eps=1e-3)
    out.backward(torch.from_numpy(g))
    b = leaves()
    ref = reference.hafner_cell(b[0], b[1], b[2], None, b[3], b[4], eps=1e-3)
    ref.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), rtol=1e-5, atol=1e-6)
    assert a[1].grad.dtype == torch.bfloat16 and a[0].grad.dtype == a[2].grad.dtype == torch.float32
    for got, want in zip(a, b):
        np.testing.assert_allclose(got.grad.float().numpy(), want.grad.float().numpy(), rtol=1e-4, atol=1e-5)


def test_cuda_launcher_refuses_other_dtypes():
    """On a CUDA tensor the wrapper launches or raises; on any tensor it
    checks the operands before it loads the library: an f16 x or a bf16 h
    is refused (only x has a bf16 variant)."""
    h, x, w = torch.zeros(2, 8), torch.zeros(2, 4), torch.zeros(12, 24)
    with pytest.raises(ValueError, match="CUDA"):
        ops.hafner_cell_cuda(h, x.to(torch.bfloat16), w, None, None, None, eps=1e-3)
    with pytest.raises(TypeError):
        ops._check_operand("x", x.half(), (2, 4), x.device, ops.CELL_X_DTYPES)
    with pytest.raises(TypeError):
        ops._check_operand("h", h.to(torch.bfloat16), (2, 8), h.device)
    with pytest.raises(TypeError):
        reference.hafner_cell(h, x.half(), w, None, None, None, eps=1e-3)


STATE = 24
VECTOR_KEYS = {"cnn_keys.encoder": [], "cnn_keys.decoder": [], "mlp_keys.encoder": ["state"],
               "mlp_keys.decoder": ["state"]}


def _vector_batch():
    batch = _batch()
    batch.pop("rgb")
    batch["state"] = (2.0 * np.random.RandomState(4).randn(*batch["rewards"].shape[:2], STATE)).astype(np.float32)
    return batch


def _jax_build(overrides, space):
    jcfg = compose(
        overrides=["exp=dreamer_v3_100k_ms_pacman", "env=dummy", "metric.log_level=0"]
        + [f"{k}={'[' + ','.join(v) + ']' if isinstance(v, list) else v}" for k, v in overrides.items()]
    )
    return jcfg, jax_agent.build_agent(jcfg, ACTIONS, False, gym.spaces.Dict(space), jax.random.PRNGKey(3))


def test_train_step_bf16_matches_jax():
    """One whole step on vector observations (the MLP encoder and decoder):
    the pixel decoder's bias gradient sums 12,288 pixels a row, which the
    JAX step accumulates in bf16 (at this batch its first element reads 125
    against 401 in f32) and the port in f32, so the pixel path is held
    module by module below instead."""
    overrides = {**BF16_OVERRIDES, **VECTOR_KEYS}
    jcfg, (wm, actor, critic, params) = _jax_build(
        overrides, {"state": gym.spaces.Box(-np.inf, np.inf, (STATE,), np.float32)}
    )
    rng = np.random.RandomState(8)
    for tree in (params["world_model"]["reward_model"], params["critic"]):
        tree["head"]["kernel"] = jnp.asarray(0.3 * rng.randn(*tree["head"]["kernel"].shape).astype(np.float32))
    params["target_critic"] = jax.tree_util.tree_map(lambda p: 0.5 * p, params["critic"])
    txs = jax_dv3.build_optimizers_and_state(jcfg, params)
    fabric = JaxFabric(devices=1, accelerator="cpu", precision="bf16-mixed")
    train_fn = jax_dv3.build_train_fn(wm, actor, critic, *txs[:3], jcfg, fabric, ACTIONS, False)
    params = jax.device_get(params)
    key, batch, tau = jax.random.PRNGKey(11), _vector_batch(), 0.02
    new_state, j_metrics = train_fn(txs[3], {k: jnp.asarray(v) for k, v in batch.items()}, key, jnp.float32(tau))
    new_state, j_metrics = jax.device_get(new_state), jax.device_get(j_metrics)

    cfg = dreamer_v3_config(**overrides)
    modules = build_agent(cfg, ACTIONS, False, {"state": (STATE,)}, device="cpu", training=True)
    state_dicts, skipped = convert_dreamer_v3(params, training=True)
    assert skipped == []
    for name, module in zip(MODULES, modules):
        module.load_state_dict(state_dicts[name])
    state = build_optimizers_and_state(cfg, *modules)
    metrics = build_train_fn(cfg, ACTIONS, False)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, _jax_noise(key), tau=tau
    )
    assert set(metrics) == set(j_metrics)
    for name, value in metrics.items():
        np.testing.assert_allclose(float(value), float(j_metrics[name]), **STEP_METRIC_TOL, err_msg=name)
    after, _ = convert_dreamer_v3(new_state["params"], training=True)
    for name in ("world_model", "actor", "critic"):
        moments, _ = convert_dreamer_v3(
            {**new_state["params"], name: _first_moments(new_state["opt"][name])}, training=True
        )
        lr = state["opt"][name].param_groups[0]["lr"]
        for pname, p in state[name].named_parameters():
            assert p.dtype == torch.float32, f"{name}.{pname}"
            got = state["opt"][name].state[p]["exp_avg"].numpy() / 0.1
            want = moments[name][pname].numpy() / 0.1
            grad_atol = STEP_GRAD_ATOL_OF_MAX * max(float(np.abs(want).max()), 1e-6)
            np.testing.assert_allclose(got, want, rtol=0, atol=grad_atol, err_msg=f"{name}.{pname} gradient")
            flip = np.abs(want) <= grad_atol  # a sign bf16 rounding may flip: Adam's first step is ±lr
            atol = np.where(flip, 2.0 * lr + 0.02 * LR, 0.02 * LR)
            diff = np.abs(p.detach().numpy() - after[name][pname].numpy())
            assert (diff <= atol).all(), f"{name}.{pname}: {diff.max()} past its tolerance"


def test_pixel_encoder_and_decoder_bf16_match_jax():
    """The CNN encoder and the pixel decoder under bf16 (the modules the
    step test leaves out): the features and the reconstruction bf16 on both
    sides, within 16·2^-8 of their largest magnitude (four stages a side,
    each a bf16 rounding of a convolution, a LayerNorm and a SiLU)."""
    jcfg, (wm, _, _, params) = _jax_build(BF16_OVERRIDES, {"rgb": gym.spaces.Box(0, 255, (3, 64, 64), np.uint8)})
    rng = np.random.RandomState(2)
    obs = rng.rand(5, 3, 64, 64).astype(np.float32) - 0.5
    latent = rng.randn(5, 4 * 4 + 32).astype(np.float32)
    j_embed = wm.apply({"params": params["world_model"]}, {"rgb": jnp.asarray(obs)}, method="encode")
    j_rec = wm.apply({"params": params["world_model"]}, jnp.asarray(latent), method="decode")["rgb"]
    cfg = dreamer_v3_config(**BF16_OVERRIDES)
    port_wm = build_agent(cfg, ACTIONS, False, {"rgb": (3, 64, 64)}, device="cpu", training=True)[0]
    port_wm.load_state_dict(convert_dreamer_v3(jax.device_get(params), training=True)[0]["world_model"])
    with torch.no_grad():
        embed = port_wm.encode({"rgb": torch.from_numpy(obs)})
        rec = port_wm.decode(torch.from_numpy(latent))["rgb"]
    for got, want in ((embed, j_embed), (rec, j_rec)):
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=16 * BF16 * np.abs(want).max())


def test_bf16_params_stay_f32_and_activations_compute_in_bf16():
    """As ``tests/test_algos/test_dreamer_v3.py`` holds the JAX build: every
    parameter f32; the encoder's features and the reconstruction bf16, the
    heads' logits and the recurrent state f32."""
    cfg = dreamer_v3_config(**BF16_OVERRIDES)
    wm, actor, critic, target = build_agent(cfg, ACTIONS, False, {"rgb": (3, 64, 64)}, device="cpu", training=True)
    for module in (wm, actor, critic, target):
        assert all(p.dtype == torch.float32 for p in module.parameters())
    assert wm.rssm.recurrent_model.gru.dtype == torch.bfloat16
    obs = {"rgb": torch.rand(2, 3, 64, 64)}
    with torch.no_grad():
        embed = wm.encode(obs)
        h = wm.recurrent_step(torch.zeros(2, 16), torch.zeros(2, ACTIONS[0]), torch.zeros(2, 32))
        latent = torch.cat([torch.zeros(2, 16), h], dim=-1)
        assert embed.dtype == torch.bfloat16 and h.dtype == torch.float32
        assert wm.decode(latent)["rgb"].dtype == torch.bfloat16
        assert wm.reward_logits(latent).dtype == torch.float32
        assert wm.rssm.prior_logits(h).dtype == torch.float32
        assert all(t.dtype == torch.float32 for t in actor(latent))
        assert critic(latent).dtype == torch.float32


def test_dreamer_v2_ignores_precision():
    """The JAX DreamerV2 agent takes no ``dtype``: under ``bf16-mixed`` the
    port's DV2 player computes in f32, bit for bit the ``32-true`` one."""
    small = dict(SMALL, **{"algo.world_model.recurrent_model.recurrent_state_size": 16})
    small.pop("algo.world_model.representation_model.hidden_size")
    small.pop("algo.world_model.transition_model.hidden_size")
    outs = []
    for precision in ("32-true", "bf16-mixed"):
        cfg = dreamer_v2_config("dreamer_v2_ms_pacman", **small, **{"fabric.precision": precision})
        wm, actor = build_dv2_agent(cfg, ACTIONS, False, {"rgb": (3, 64, 64)}, seed=5, device="cpu")
        with torch.no_grad():
            embed = wm.encode({"rgb": torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(1))})
        assert embed.dtype == torch.float32
        assert all(p.dtype == torch.float32 for p in (*wm.parameters(), *actor.parameters()))
        outs.append(embed)
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)

"""The port's LayerNorm-GRU cell against the JAX package's.

On the CPU the port's wrapper runs its plain PyTorch version; it is held
against the Pallas TPU kernel run in interpret mode (as the JAX package's own
kernel tests run it) and against the JAX reference cell. Inputs are made
with numpy from a seed and handed to both sides.

Tolerances, the JAX kernel suite's own: forward rtol/atol 2e-5; gradients
(the port's hand-derived VJP against the Pallas cell's ``jax.custom_vjp``,
the VJP of its padded XLA program) rtol 2e-4, atol 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.kernels import pallas_tpu
from sheeprl_tpu.kernels import reference as jax_reference
from sheeprl_tpu_torch.kernels import build, ops, reference

TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)


def _operands(B, H, X, *, bias, layer_norm, seed=0):
    rng = np.random.RandomState(seed)
    h = rng.randn(B, H).astype(np.float32)
    x = rng.randn(B, X).astype(np.float32)
    kernel = (rng.randn(H + X, 3 * H) * 0.1).astype(np.float32)
    b = (rng.randn(3 * H) * 0.1).astype(np.float32) if bias else None
    if layer_norm:
        s = (1.0 + 0.1 * rng.randn(3 * H)).astype(np.float32)
        lb = (0.1 * rng.randn(3 * H)).astype(np.float32)
    else:
        s = lb = None
    return h, x, kernel, b, s, lb


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("layer_norm", [True, False], ids=["ln", "no_ln"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("eps", [1e-5, 1e-3])
@pytest.mark.parametrize("B", [1, 5])
@pytest.mark.parametrize("X", [400, 37])
@pytest.mark.parametrize("H", [600, 599, 128, 1])
def test_plain_cell_matches_pallas_interpret_and_reference(H, X, B, eps, bias, layer_norm):
    ops_np = _operands(B, H, X, bias=bias, layer_norm=layer_norm, seed=H + X + B)
    pallas = np.asarray(
        pallas_tpu.hafner_cell(
            *ops_np, hidden_size=H, eps=eps, layer_norm=layer_norm, interpret=True
        )
    )
    ref = np.asarray(jax_reference.hafner_cell(*ops_np, eps=eps))
    with torch.inference_mode():
        out = ops.hafner_gru_cell(*_torch(*ops_np), eps=eps).numpy()
    assert out.shape == (B, H)
    np.testing.assert_allclose(out, pallas, **TOL)
    np.testing.assert_allclose(out, ref, **TOL)


def test_cpu_wrapper_runs_plain_version_without_counting_a_launch():
    args = _torch(*_operands(3, 16, 8, bias=True, layer_norm=True))
    before = ops.hafner_cell_launches.count
    out = ops.hafner_gru_cell(*args, eps=1e-5)
    assert ops.hafner_cell_launches.count == before
    torch.testing.assert_close(out, reference.hafner_cell(*args, eps=1e-5), rtol=0, atol=0)


def test_cuda_launcher_refuses_cpu_tensors():
    args = _torch(*_operands(2, 8, 4, bias=True, layer_norm=True))
    with pytest.raises(ValueError, match="CUDA"):
        ops.hafner_cell_cuda(*args, eps=1e-5)


def test_backward_raises_until_the_training_slice():
    """The training slice has come: the backward no longer raises, and gives
    all six gradients as autograd of the plain version does."""
    ops_t = _torch(*_operands(2, 8, 4, bias=True, layer_norm=True))
    leaves = [t.clone().requires_grad_(True) for t in ops_t]
    ops.hafner_gru_cell(*leaves, eps=1e-5).sum().backward()
    plain = [t.clone().requires_grad_(True) for t in ops_t]
    reference.hafner_cell(*plain, eps=1e-5).sum().backward()
    for got, want in zip(leaves, plain):
        torch.testing.assert_close(got.grad, want.grad, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("layer_norm", [True, False], ids=["ln", "no_ln"])
@pytest.mark.parametrize("H,X", [(600, 400), (599, 37), (128, 64), (1, 37)])
def test_cell_vjp_matches_pallas_custom_vjp(H, X, layer_norm):
    ops_np = _operands(5, H, X, bias=True, layer_norm=layer_norm, seed=H + 3 * X)
    present = [i for i, a in enumerate(ops_np) if a is not None]

    def loss(*a):
        full = list(ops_np)
        for i, v in zip(present, a):
            full[i] = v
        return jnp.sum(jnp.tanh(pallas_tpu.hafner_cell(
            *full, hidden_size=H, eps=1e-5, layer_norm=layer_norm, interpret=True)))

    want = jax.jit(jax.grad(loss, argnums=tuple(range(len(present)))))(*[ops_np[i] for i in present])
    leaves = [None if a is None else torch.from_numpy(a).requires_grad_(True) for a in ops_np]
    out = ops.hafner_gru_cell(*leaves, eps=1e-5)
    got = torch.autograd.grad(torch.tanh(out).sum(), [leaves[i] for i in present])
    for i, g, w in zip(present, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL, err_msg=f"operand {i}")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda _name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build._nvcc()


def test_library_name_follows_source_and_flags(monkeypatch):
    path = build._library_path("hafner_gru")
    assert path.parent == build.BUILD_DIR and path.name.startswith("libhafner_gru_")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ["-lineinfo"])
    assert build._library_path("hafner_gru") != path


def test_variant_source_changes_one_constant():
    from sheeprl_tpu_torch.tools.bench_variants import variant_source

    source = build.SOURCES["hafner_gru"].read_text()
    variant = variant_source(source, "kWideWG", "2")
    changed = [(a, b) for a, b in zip(source.splitlines(), variant.splitlines()) if a != b]
    assert len(changed) == 1 and changed[0][1].startswith("constexpr int kWideWG = 2;")
    with pytest.raises(SystemExit, match="no constant"):
        variant_source(source, "kNoSuchConstant", "1")

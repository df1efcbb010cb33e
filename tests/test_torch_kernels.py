"""The port's LayerNorm-GRU cell against the JAX package's.

On the CPU the port's wrapper runs its plain PyTorch version; it is held
against the Pallas TPU kernel run in interpret mode (as the JAX package's own
kernel tests run it) and against the JAX reference cell. Inputs are made
with numpy from a seed and handed to both sides.

Tolerance: forward rtol/atol 2e-5, the JAX kernel suite's own.
"""

import numpy as np
import pytest
import torch

from sheeprl_tpu.kernels import pallas_tpu
from sheeprl_tpu.kernels import reference as jax_reference
from sheeprl_tpu_torch.kernels import build, ops, reference

TOL = dict(rtol=2e-5, atol=2e-5)


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
    h, x, kernel, b, s, lb = _torch(*_operands(2, 8, 4, bias=True, layer_norm=True))
    kernel.requires_grad_(True)
    out = ops.hafner_gru_cell(h, x, kernel, b, s, lb, eps=1e-5)
    with pytest.raises(NotImplementedError, match="training slice"):
        out.sum().backward()


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


"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA card and skips without one. The file imports
neither JAX nor the JAX package, so it also runs where only PyTorch is
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerance: abs 1e-4 (float32 against float32 with another summation order
over K = H + X; TF32 is off for the plain version's matmul).
"""

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch.kernels import ops, reference

TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


def _operands(B, H, X, *, bias, layer_norm, device, seed=0):
    rng = np.random.RandomState(seed)

    def t(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy((shift + scale * rng.randn(*shape)).astype(np.float32)).to(device)

    h, x, kernel = t(B, H), t(B, X), t(H + X, 3 * H, scale=0.1)
    b = t(3 * H, scale=0.1) if bias else None
    s = t(3 * H, scale=0.1, shift=1.0) if layer_norm else None
    lb = t(3 * H, scale=0.1) if layer_norm else None
    return h, x, kernel, b, s, lb


@pytest.mark.cuda
@pytest.mark.parametrize(
    "H,X,bias,layer_norm",
    [(600, 400, True, True), (599, 37, False, False), (128, 400, False, True), (1, 37, True, False)],
)
@pytest.mark.parametrize("B", [1, 5, 16, 64])
def test_kernel_matches_plain_version(cuda, B, H, X, bias, layer_norm):
    args = _operands(B, H, X, bias=bias, layer_norm=layer_norm, device=cuda, seed=B + H + X)
    before = ops.hafner_cell_launches.count
    out = ops.hafner_gru_cell(*args, eps=1e-5)
    torch.cuda.synchronize()
    assert ops.hafner_cell_launches.count == before + 1
    plain = reference.hafner_cell(*args, eps=1e-5)
    assert out.shape == (B, H) and torch.isfinite(out).all()
    assert (out - plain).abs().max().item() <= TOL


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    h, x, kernel, b, s, lb = _operands(2, 8, 4, bias=True, layer_norm=True, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        ops.hafner_gru_cell(h.double(), x, kernel, b, s, lb, eps=1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        ops.hafner_gru_cell(h, x, kernel.t().contiguous().t(), b, s, lb, eps=1e-5)
    with pytest.raises(ValueError, match="come together"):
        ops.hafner_gru_cell(h, x, kernel, b, s, None, eps=1e-5)

"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA card and skips without one. The file imports
neither JAX nor the JAX package, so it also runs where only PyTorch is
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: forward abs 1e-4 (the kernel's 3xTF32 product on the tensor
cores against float32, another summation order over K = H + X; TF32 is off
for the plain version's matmul); gradients 1e-4 of each gradient's largest magnitude (the hand VJP
against autograd of the plain version: other summation orders, and
gradients of W that sum over the batch).
"""

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch.kernels import ops, reference

TOL = 1e-4
GRAD_TOL = 1e-4


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
@pytest.mark.parametrize("B", [1, 5, 16, 63, 64, 65, 127, 129, 257, 801, 1600])
def test_kernel_matches_plain_version(cuda, B, H, X, bias, layer_norm):
    """Batch sizes at the product's tile edges (8, 16, 32, 64 and 128 rows a
    block) and the paths' own; widths with and without 16-byte copies."""
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


def _grads(fn, args, cot):
    leaves = [a.detach().requires_grad_(True) if a is not None else None for a in args]
    out = fn(*leaves)
    return out.detach(), torch.autograd.grad(out, [a for a in leaves if a is not None], cot)


def _assert_grads_close(got, want):
    for g, w in zip(got, want):
        assert ((g - w).abs().max() / w.abs().max().clamp_min(1e-30)).item() <= GRAD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("B", [32, 801, 1600])
def test_cell_at_training_batches_with_gradients(cuda, B):
    """The backward runs at the pre-activation the forward kept (one K split
    at B=801 and 1600: the gate kernel writes it over its partial; several
    at B=32): that z is [h|x]·W + b (within 1e-4 of its largest magnitude,
    as the gradients are held), and the six gradients match autograd of the
    plain version."""
    args = _operands(B, 600, 400, bias=True, layer_norm=True, device=cuda, seed=B)
    _out, z = ops.hafner_cell_cuda(*args, eps=1e-5, save_z=True)
    h, x, kernel, b = args[:4]
    z_plain = torch.cat([h, x], dim=-1) @ kernel + b
    assert ((z - z_plain).abs().max() / z_plain.abs().max()).item() <= GRAD_TOL
    cot = torch.randn(B, 600, device=cuda, generator=torch.Generator(device=cuda).manual_seed(B))
    out, got = _grads(lambda *a: ops.hafner_gru_cell(*a, eps=1e-5), args, cot)
    plain, want = _grads(lambda *a: reference.hafner_cell(*a, eps=1e-5), args, cot)
    assert (out - plain).abs().max().item() <= TOL
    _assert_grads_close(got, want)


#: the kernel bench's shape, an odd one (last unit group of 11 units, scalar
#: copies, no bias, no LayerNorm), the widest batch the persistent
#: recurrence takes, and one past its limits (W[:H] does not fit on chip)
SEQUENCE_SHAPES = [
    (50, 16, 600, 400, True, True),
    (7, 5, 599, 37, False, False),
    (50, 64, 600, 400, True, True),
    (8, 16, 2048, 512, True, True),
]


def _sequence_args(T, B, H, X, bias, layer_norm, device):
    h0, x, kernel, b, s, lb = _operands(B, H, X, bias=bias, layer_norm=layer_norm, device=device, seed=T + H)
    xs = torch.randn(T, B, X, device=device, generator=torch.Generator(device=device).manual_seed(T))
    return (h0, xs, kernel, b, s, lb)


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H,X,bias,layer_norm", SEQUENCE_SHAPES)
def test_sequence_kernel_matches_plain_loop(cuda, T, B, H, X, bias, layer_norm):
    """The plan's variant: forward and the six gradients (the VJP at the
    kept z) against the plain loop under autograd; the launch is counted
    under the variant the plan names."""
    args = _sequence_args(T, B, H, X, bias, layer_norm, cuda)
    cot = torch.randn(T, B, H, device=cuda, generator=torch.Generator(device=cuda).manual_seed(B))
    plan = ops.hafner_sequence_variant(T, B, H, X)
    assert plan["variant"] == ("multi_launch" if H == 2048 else "persistent")
    before = ops.hafner_sequence_launches.count
    before_variant = ops.hafner_sequence_launches.by_variant.get(plan["variant"], 0)
    hs, got = _grads(lambda *a: ops.hafner_gru_sequence(*a, eps=1e-3), args, cot)
    assert ops.hafner_sequence_launches.count == before + 1
    assert ops.hafner_sequence_launches.by_variant[plan["variant"]] == before_variant + 1
    plain, want = _grads(lambda *a: reference.hafner_sequence(*a, eps=1e-3), args, cot)
    assert hs.shape == (T, B, H) and torch.isfinite(hs).all()
    assert (hs - plain).abs().max().item() <= TOL
    _assert_grads_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H,X,bias,layer_norm", SEQUENCE_SHAPES)
def test_sequence_variants_are_right_and_deterministic(cuda, T, B, H, X, bias, layer_norm):
    """Each variant that fits, named explicitly: hs within 1e-4 of the plain
    loop, the kept z within 1e-4 of the plain z's largest magnitude, and two
    calls bit-identical (a fault in a grid barrier shows as a difference)."""
    args = _sequence_args(T, B, H, X, bias, layer_norm, cuda)
    plain, plain_z = reference.hafner_sequence_with_z(*args, eps=1e-3)
    fits = ops.hafner_sequence_variant(T, B, H, X)["variant"] == "persistent"
    for variant in ("persistent", "multi_launch") if fits else ("multi_launch",):
        hs, z = ops.hafner_sequence_cuda(*args, eps=1e-3, save_z=True, variant=variant)
        again = ops.hafner_sequence_cuda(*args, eps=1e-3, variant=variant)
        torch.cuda.synchronize()
        assert (hs - plain).abs().max().item() <= TOL, variant
        assert ((z - plain_z).abs().max() / plain_z.abs().max()).item() <= GRAD_TOL, variant
        assert torch.equal(hs, again), variant
    if not fits:
        with pytest.raises(ValueError, match="does not fit"):
            ops.hafner_sequence_cuda(*args, eps=1e-3, variant="persistent")


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H,X,bias,layer_norm", SEQUENCE_SHAPES[:2] + SEQUENCE_SHAPES[3:])
def test_sequence_replays_from_a_cuda_graph(cuda, T, B, H, X, bias, layer_norm):
    """The call captured in a CUDA graph (the persistent recurrence is a
    cooperative cluster launch) and replayed gives the eager call's hs."""
    args = _sequence_args(T, B, H, X, bias, layer_norm, cuda)
    eager = ops.hafner_sequence_cuda(*args, eps=1e-3)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        ops.hafner_sequence_cuda(*args, eps=1e-3)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = ops.hafner_sequence_cuda(*args, eps=1e-3)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)


# a short DreamerV2 run through the port's CLI at a small width on the dummy env: 16 updates of 2
# envs, learning from update 8 (2 acting steps of the player's at B=2 before the last train burst)
CLI_RUN = [
    "exp=dreamer_v2", "env=dummy", "env.id=discrete_dummy", "env.num_envs=2", "env.sync_env=True",
    "metric.log_level=0", "buffer.memmap=False", "buffer.size=256", "total_steps=32",
    "algo.learning_starts=16", "algo.train_every=4", "algo.per_rank_pretrain_steps=2",
    "per_rank_batch_size=4", "per_rank_sequence_length=8", "algo.horizon=4", "algo.dense_units=32",
    "algo.mlp_layers=1", "algo.world_model.encoder.cnn_channels_multiplier=4",
    "algo.world_model.recurrent_model.recurrent_state_size=64", "algo.world_model.transition_model.hidden_size=32",
    "algo.world_model.representation_model.hidden_size=32", "algo.world_model.stochastic_size=4",
    "algo.world_model.discrete_size=4", "run_name=card",
]


@pytest.mark.cuda
def test_cli_run_on_the_card_launches_the_cell_and_round_trips_its_checkpoint(cuda, tmp_path):
    """The CLI on ``cuda`` (``fabric.accelerator=auto``): the cell launches
    once per acting and test step and (T + horizon) times per gradient step;
    the checkpoint validates, resumes, and serves on the card what it serves
    with the plain cell."""
    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.ckpt import read_checkpoint, validate_checkpoint
    from sheeprl_tpu_torch.serve.model import load_gateway_model

    ops.hafner_cell_launches.reset()
    result = cli.run(CLI_RUN + [f"root_dir={tmp_path}"])
    per_step = 8 + 4
    assert result["gradient_steps"] > 0 and result["player_steps"] > 0
    assert ops.hafner_cell_launches.count == (
        result["player_steps"] + per_step * result["gradient_steps"] + result["test_steps"]
    )
    ckpt = result["checkpoint"]
    assert validate_checkpoint(ckpt, deep=True)["framework"] == "torch"
    saved = read_checkpoint(ckpt)["agent"]["world_model"]["rssm.recurrent_model.gru.weight"]
    assert saved.shape == (32 + 64, 3 * 64) and np.isfinite(saved).all()

    resumed = cli.run(CLI_RUN + [f"root_dir={tmp_path}", f"checkpoint.resume_from={ckpt}", "total_steps=40"])
    assert resumed["updates"] > 0

    model, *_ = load_gateway_model(ckpt)
    plain, *_ = load_gateway_model(ckpt, plain_cell=True)
    assert model.device.type == "cuda"
    frames = {"rgb": np.random.RandomState(0).randint(0, 256, (3, 3, 64, 64)).astype(np.uint8)}
    got = model.act(frames, model.init_state_rows(3), torch.Generator(device="cuda").manual_seed(0))
    want = plain.act(frames, plain.init_state_rows(3), torch.Generator(device="cuda").manual_seed(0))
    np.testing.assert_array_equal(got[0], want[0])
    torch.testing.assert_close(got[1]["recurrent"], want[1]["recurrent"], atol=TOL, rtol=0)

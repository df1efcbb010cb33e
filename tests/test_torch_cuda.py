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


# a small DreamerV2 trainer for the graph tests: the same code path as the full width, in seconds
GRAPH_SMALL = {
    "algo.dense_units": 32, "algo.mlp_layers": 1, "algo.world_model.encoder.cnn_channels_multiplier": 4,
    "algo.world_model.recurrent_model.recurrent_state_size": 64, "algo.world_model.stochastic_size": 4,
    "algo.world_model.discrete_size": 4, "algo.world_model.transition_model.hidden_size": 32,
    "algo.world_model.representation_model.hidden_size": 32, "algo.horizon": 4,
    "per_rank_batch_size": 4, "per_rank_sequence_length": 8,
}
GRAPH_REPLAYS = 5
# relative to each tensor's largest magnitude, with cuDNN's deterministic algorithms: its default convolution
# weight gradients accumulate with atomics, and then two eager runs already differ by more
GRAPH_TOL = 1e-6


def _trainer(device):
    from sheeprl_tpu_torch.tools import bench_dreamer

    return bench_dreamer.build_trainer(device, seed=0, **GRAPH_SMALL)


@pytest.mark.cuda
def test_graphed_train_burst_equals_the_eager_steps(cuda, monkeypatch):
    """The same state, batches and noise through the eager steps and through
    one burst (the capture's warm-up calls, the capture, then GRAPH_REPLAYS
    replays): every step's losses and gradient norms, and the parameters
    after the last step, with cuDNN's deterministic algorithms."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    from sheeprl_tpu_torch.train.burst import run_train_burst, tau_schedule
    from sheeprl_tpu_torch.train.graphs import WARMUP_CALLS
    from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import draw_noise

    n = WARMUP_CALLS + GRAPH_REPLAYS
    taus = tau_schedule(n, 0, 3, tau=1.0, first_hard=False)
    cfg, _state, _program, data = _trainer(cuda)
    T, B = data["rewards"].shape[:2]
    gen = torch.Generator(device=cuda).manual_seed(1)
    noise = [draw_noise(cfg, (9,), T, B, gen, cuda) for _ in range(n)]
    stack = {k: torch.stack([torch.roll(v, i, dims=1) for i in range(n)]) for k, v in data.items()}
    out = {}
    for fused in (False, True):
        _cfg, state, program, _data = _trainer(cuda)
        before = ops.hafner_cell_launches.count
        metrics = [run_train_burst(program, state, {k: v[i : i + 1] for k, v in stack.items()}, taus[i : i + 1],
                                   noise=noise[i : i + 1], fused=fused) for i in range(n)]
        launches = ops.hafner_cell_launches.count - before
        params = [p.detach().clone() for name in ("world_model", "actor", "critic", "target_critic")
                  for p in state[name].parameters()]
        out[fused] = (metrics, params, launches)
        if fused:
            step = program.static.step
            assert (step.eager_calls, step.replays) == (WARMUP_CALLS, GRAPH_REPLAYS)
            assert step.graph is not None and step.warmup_s > 0
    (em, ep, el), (gm, gp, gl) = out[False], out[True]
    assert el == gl == n * (T + 4)
    for g, e in zip(gm, em):
        for k in e:
            assert abs(g[k] - e[k]) <= GRAPH_TOL * max(abs(e[k]), 1e-30), (k, g[k], e[k])
    for g, e in zip(gp, ep):
        assert (g - e).abs().max() <= GRAPH_TOL * e.abs().max().clamp_min(1e-30)


@pytest.mark.cuda
def test_graphed_acting_step_equals_the_eager_one(cuda):
    """16 acting steps at injected noise and random reset masks, through the
    acting step's graph and through the eager ``exploration_action``."""
    from sheeprl_tpu_torch.algos.dreamer_v2.agent import ExplorationStep, build_agent, build_player_fns
    from sheeprl_tpu_torch.algos.dreamer_v2.utils import normalize_obs
    from sheeprl_tpu_torch.configs import dreamer_v2_config
    from sheeprl_tpu_torch.train.graphs import WARMUP_CALLS

    cfg = dreamer_v2_config(**GRAPH_SMALL)
    wm, actor = build_agent(cfg, (3, 2), False, {"rgb": (3, 64, 64)}, seed=4, device=cuda)
    fns = build_player_fns(wm, actor, cfg, (3, 2), False)
    n, rng = 4, np.random.RandomState(5)
    gen = torch.Generator(device=cuda).manual_seed(8)
    acting = ExplorationStep(fns, n, {"rgb": np.zeros((n, 3, 64, 64), np.uint8)}, ["rgb"], None, cuda)
    state = fns["init_states"](n)
    for step in range(16):
        obs = {"rgb": rng.randint(0, 256, (n, 3, 64, 64)).astype(np.uint8)}
        mask = (rng.uniform(size=(n, 1)) < 0.25).astype(np.float32)
        noise = fns["draw_exploration_noise"](n, gen)
        got = [a.clone() for a in acting(obs, mask, step / 15, noise=noise)]
        state = fns["reset_states"](state, torch.from_numpy(mask))
        want, state = fns["exploration_action"](state, normalize_obs(obs, ["rgb"], cuda), step / 15,
                                                gumbel=noise["gumbel"], action_gumbels=noise["action_gumbels"],
                                                expl_noise=noise["expl_noise"])
        for g, w in zip(got, want):
            assert torch.equal(g.argmax(-1), w.argmax(-1)), step
            torch.testing.assert_close(g, w, atol=TOL, rtol=0)
        torch.testing.assert_close(acting.state["recurrent"], state["recurrent"], atol=TOL, rtol=0)
    assert (acting.step.eager_calls, acting.step.replays) == (WARMUP_CALLS, 16 - WARMUP_CALLS)


@pytest.mark.cuda
def test_launch_counts_under_replay_equal_the_profiler_count(cuda):
    """The counters a capture records and adds back on every replay against
    the gate kernels the device ran, counted from a ``torch.profiler`` trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sheeprl_tpu_torch.train.graphs import WARMUP_CALLS

    cfg, state, program, data = _trainer(cuda)
    stack = {k: v[None] for k, v in data.items()}
    for _ in range(WARMUP_CALLS + 1):  # the warm-up calls, the capture and one replay
        program.burst(state, stack, [0.0])
    torch.cuda.synchronize()
    ops.hafner_cell_launches.reset()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            program.burst(state, stack, [0.0])
        torch.cuda.synchronize()
    gates = sum(e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and "hafner_gates_kernel" in e.key)
    T = data["rewards"].shape[0]
    assert ops.hafner_cell_launches.count == 3 * (T + 4) == gates


# ---------------------------------------------------------------------------
# DreamerV3: the cell at the 100k preset's shapes, graphed steps, the CLI run
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 16, 1024])
def test_cell_at_dreamer_v3_shapes_with_gradients(cuda, B):
    """H = X = 512, no bias, LayerNorm with eps 1e-3, at the batches of the
    DV3 paths (acting, posterior, imagination): the forward, and the five
    gradients (none for the missing bias) against autograd of the plain
    version."""
    args = _operands(B, 512, 512, bias=False, layer_norm=True, device=cuda, seed=B + 3)
    variant = ops.hafner_cell_variant(B, 512, 512)
    assert variant["grid"][1] * variant["tile_rows"] >= B and variant["grid"][0] * 64 * variant["warpgroups"] >= 3 * 512
    cot = torch.randn(B, 512, device=cuda, generator=torch.Generator(device=cuda).manual_seed(B))
    before = ops.hafner_cell_launches.count
    out, got = _grads(lambda *a: ops.hafner_gru_cell(*a, eps=1e-3), args, cot)
    assert ops.hafner_cell_launches.count == before + 1
    plain, want = _grads(lambda *a: reference.hafner_cell(*a, eps=1e-3), args, cot)
    assert len(got) == len(want) == 5
    assert (out - plain).abs().max().item() <= TOL
    _assert_grads_close(got, want)


GRAPH_SMALL_DV3 = {
    "algo.dense_units": 32, "algo.mlp_layers": 1, "algo.world_model.encoder.cnn_channels_multiplier": 4,
    "algo.world_model.recurrent_model.recurrent_state_size": 64, "algo.world_model.stochastic_size": 4,
    "algo.world_model.discrete_size": 4, "algo.world_model.transition_model.hidden_size": 32,
    "algo.world_model.representation_model.hidden_size": 32, "algo.horizon": 4,
    "per_rank_batch_size": 4, "per_rank_sequence_length": 8,
}


@pytest.mark.cuda
def test_graphed_dv3_train_burst_equals_the_eager_steps(cuda, monkeypatch):
    """The DV3 step as the DV2 one above: eager steps against one burst of
    replays at the same state, batches, noise and τ schedule (hard first,
    then 0.02), with cuDNN's deterministic algorithms; (T + horizon) cell
    launches a step on both."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import draw_noise
    from sheeprl_tpu_torch.tools import bench_dreamer
    from sheeprl_tpu_torch.train.burst import run_train_burst, tau_schedule
    from sheeprl_tpu_torch.train.graphs import WARMUP_CALLS

    n = WARMUP_CALLS + GRAPH_REPLAYS
    taus = tau_schedule(n, 0, 1, tau=0.02, first_hard=True)
    build = lambda: bench_dreamer.build_trainer(cuda, seed=0, algo="dreamer_v3", **GRAPH_SMALL_DV3)  # noqa: E731
    cfg, _state, _program, data = build()
    T, B = data["rewards"].shape[:2]
    gen = torch.Generator(device=cuda).manual_seed(1)
    noise = [draw_noise(cfg, (9,), T, B, gen, cuda) for _ in range(n)]
    stack = {k: torch.stack([torch.roll(v, i, dims=1) for i in range(n)]) for k, v in data.items()}
    out = {}
    for fused in (False, True):
        _cfg, state, program, _data = build()
        before = ops.hafner_cell_launches.count
        metrics = [run_train_burst(program, state, {k: v[i : i + 1] for k, v in stack.items()}, taus[i : i + 1],
                                   noise=noise[i : i + 1], fused=fused) for i in range(n)]
        launches = ops.hafner_cell_launches.count - before
        params = [p.detach().clone() for name in ("world_model", "actor", "critic", "target_critic")
                  for p in state[name].parameters()] + [v.clone() for v in state["moments"].values()]
        out[fused] = (metrics, params, launches)
    (em, ep, el), (gm, gp, gl) = out[False], out[True]
    assert el == gl == n * (T + 4)
    for g, e in zip(gm, em):
        for k in e:
            assert abs(g[k] - e[k]) <= GRAPH_TOL * max(abs(e[k]), 1e-30), (k, g[k], e[k])
    for g, e in zip(gp, ep):
        assert (g - e).abs().max() <= GRAPH_TOL * e.abs().max().clamp_min(1e-30)


@pytest.mark.cuda
def test_graphed_dv3_acting_step_equals_the_eager_one(cuda):
    """16 DV3 acting steps at injected noise through the acting step's graph
    (resets outside it, as the run makes them) and through the eager
    ``exploration_action``."""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import ExplorationStep, build_agent, build_player_fns
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import normalize_obs
    from sheeprl_tpu_torch.configs import dreamer_v3_config
    from sheeprl_tpu_torch.train.graphs import WARMUP_CALLS

    cfg = dreamer_v3_config(**GRAPH_SMALL_DV3)
    wm, actor = build_agent(cfg, (9,), False, {"rgb": (3, 64, 64)}, seed=4, device=cuda)
    fns = build_player_fns(wm, actor, cfg, (9,), False)
    n, rng = 4, np.random.RandomState(5)
    gen = torch.Generator(device=cuda).manual_seed(8)
    acting = ExplorationStep(fns, n, {"rgb": np.zeros((n, 3, 64, 64), np.uint8)}, ["rgb"], None, cuda,
                             reset_in_step=False)
    state = fns["init_states"](n)
    for step in range(16):
        obs = {"rgb": rng.randint(0, 256, (n, 3, 64, 64)).astype(np.uint8)}
        mask = (rng.uniform(size=(n, 1)) < 0.25).astype(np.float32)
        acting.reset(mask)
        state = fns["reset_states"](state, torch.from_numpy(mask))
        noise = fns["draw_exploration_noise"](n, gen)
        got = [a.clone() for a in acting(obs, None, 0.0, noise=noise)]
        want, state = fns["exploration_action"](state, normalize_obs(obs, ["rgb"], cuda), 0.0,
                                                gumbel=noise["gumbel"], action_gumbels=noise["action_gumbels"],
                                                expl_noise=noise["expl_noise"])
        for g, w in zip(got, want):
            assert torch.equal(g.argmax(-1), w.argmax(-1)), step
            torch.testing.assert_close(g, w, atol=TOL, rtol=0)
        torch.testing.assert_close(acting.state["stochastic"], state["stochastic"], atol=TOL, rtol=0)
    assert (acting.step.eager_calls, acting.step.replays) == (WARMUP_CALLS, 16 - WARMUP_CALLS)


@pytest.mark.cuda
def test_dv3_cli_run_on_the_card_launches_the_cell_and_serves_its_checkpoint(cuda, tmp_path):
    """The DV3 CLI on ``cuda``: the cell launches once per acting and test
    step and (T + horizon) times per gradient step; the checkpoint serves on
    the card what it serves with the plain cell."""
    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.serve.model import load_gateway_model

    run = [
        "exp=dreamer_v3", "env=dummy", "env.id=discrete_dummy", "env.num_envs=2", "env.sync_env=True",
        "metric.log_level=0", "buffer.memmap=False", "buffer.size=256", "total_steps=48", "algo.learning_starts=16",
        "algo.train_every=2", "per_rank_batch_size=4", "per_rank_sequence_length=8", "run_name=card_dv3",
        f"root_dir={tmp_path}",
    ] + [f"{k}={v}" for k, v in GRAPH_SMALL_DV3.items() if not k.startswith("per_rank")]
    ops.hafner_cell_launches.reset()
    result = cli.run(run)
    assert result["gradient_steps"] > 3 and result["player_steps"] > 3
    assert ops.hafner_cell_launches.count == result["player_steps"] + 12 * result["gradient_steps"] + result[
        "test_steps"]
    model, *_ = load_gateway_model(result["checkpoint"])
    plain, *_ = load_gateway_model(result["checkpoint"], plain_cell=True)
    frames = {"rgb": np.random.RandomState(0).randint(0, 256, (3, 3, 64, 64)).astype(np.uint8)}
    got = model.act(frames, model.init_state_rows(3), torch.Generator(device="cuda").manual_seed(0))
    want = plain.act(frames, plain.init_state_rows(3), torch.Generator(device="cuda").manual_seed(0))
    np.testing.assert_array_equal(got[0], want[0])
    torch.testing.assert_close(got[1]["recurrent"], want[1]["recurrent"], atol=TOL, rtol=0)


@pytest.fixture(scope="module")
def card_dv3_checkpoint(tmp_path_factory):
    """A tiny DV3 run on the card (the dummy env, random actions only): its checkpoint."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from sheeprl_tpu_torch import cli

    root = tmp_path_factory.mktemp("card_eval")
    run = [
        "exp=dreamer_v3", "env=dummy", "env.id=discrete_dummy", "env.num_envs=1", "env.sync_env=True",
        "metric.log_level=0", "buffer.memmap=False", "total_steps=16", "algo.learning_starts=100",
        "algo.run_test=False", "run_name=card_eval", f"root_dir={root}",
    ] + [f"{k}={v}" for k, v in GRAPH_SMALL_DV3.items() if not k.startswith("per_rank")]
    return cli.run(run)["checkpoint"]


@pytest.mark.cuda
def test_rescore_through_gateway_on_the_card_is_bitwise_the_evaluation(cuda, card_dv3_checkpoint):
    """On the card, the gateway-path rescore gives the eval service's returns
    and lengths bit for bit at matched seeds, with one cell launch a pool
    step (and a batch) on each path."""
    from sheeprl_tpu_torch.evals.service import evaluate_checkpoint
    from sheeprl_tpu_torch.serve import rescore_through_gateway

    ops.hafner_cell_launches.reset()
    direct = evaluate_checkpoint(card_dv3_checkpoint, episodes=4, seed0=3, write_registry=False)
    assert ops.hafner_cell_launches.count == max(direct["lengths"])
    ops.hafner_cell_launches.reset()
    gated = rescore_through_gateway(card_dv3_checkpoint, episodes=4, seed0=3)
    assert ops.hafner_cell_launches.count == gated["batches"] == max(direct["lengths"])
    assert gated["returns"] == direct["returns"] and gated["lengths"] == direct["lengths"]


@pytest.mark.cuda
def test_the_ring_and_the_drain_on_the_card(cuda, card_dv3_checkpoint, tmp_path):
    """Spawned ring clients served from the card; the drain then finishes
    the queued requests and refuses later ones."""
    import json

    from sheeprl_tpu_torch.serve import ServeClosed, ServeGateway
    from sheeprl_tpu_torch.serve.gateway import spawn_clients

    gateway = ServeGateway.from_checkpoint(card_dv3_checkpoint, max_batch=4, deadline_s=0.002)
    try:
        ring = gateway.start_ring(2)
        spec = {"requests": 5, "seed": 1, "out_dir": str(tmp_path / "clients")}
        for p in spawn_clients(ring, 2, "sheeprl_tpu_torch.serve.loadgen:seeded_client", spec):
            p.join(timeout=120)
            assert p.exitcode == 0
        for slot in range(2):
            with open(tmp_path / "clients" / f"client_{slot}.json") as f:
                seen = json.load(f)
            assert seen["errors"] == [] and len(seen["versions"]) == 5 and not seen["torch_loaded"]
        rows = {k: np.zeros(s.shape, s.dtype) for k, s in gateway.observation_space.spaces.items()}
        tickets = [gateway.batcher.submit(f"c{i}", rows) for i in range(6)]
        assert gateway.drain(timeout=30.0) is True
        assert all(gateway.batcher.wait(t, timeout=1.0)[0] is not None for t in tickets)
        with pytest.raises(ServeClosed):
            gateway.client().act(rows)
        assert gateway.status()["failed_requests"] == 0 and gateway.status()["requests"] == 16
    finally:
        gateway.close()


# Plan2Explore: the cell at its presets' shapes, (H, X, bias, eps): P2E-DV3 at DreamerV3's default algo width,
# P2E-DV2 at its own with DreamerV2's eps
P2E_CELLS = [(256, 256, False, 1e-3), (400, 400, True, 1e-5)]


@pytest.mark.cuda
@pytest.mark.parametrize("H,X,bias,eps", P2E_CELLS)
@pytest.mark.parametrize("B", [4, 10, 16, 64, 800, 1024])
def test_cell_at_p2e_shapes_with_gradients(cuda, B, H, X, bias, eps):
    """The forward and the hand VJP's gradients (five without bias, six
    with) against autograd of the plain version at P2E's shapes."""
    args = _operands(B, H, X, bias=bias, layer_norm=True, device=cuda, seed=B + H)
    leaves = [a.detach().requires_grad_(True) if a is not None else None for a in args]
    plain_leaves = [a.detach().requires_grad_(True) if a is not None else None for a in args]
    out = ops.hafner_gru_cell(*leaves, eps=eps)
    want = reference.hafner_cell(*plain_leaves, eps=eps)
    assert (out - want).abs().max().item() <= TOL
    cot = torch.randn_like(out)
    got = torch.autograd.grad(out, [a for a in leaves if a is not None], cot)
    exp = torch.autograd.grad(want, [a for a in plain_leaves if a is not None], cot)
    assert len(got) == 5 + int(bias)
    for g, e in zip(got, exp):
        assert (g - e).abs().max().item() <= GRAD_TOL * e.abs().max().clamp_min(1e-30).item()


@pytest.mark.cuda
@pytest.mark.parametrize("algo,per_step", [("p2e_dv3", 8 + 2 * 4), ("p2e_dv3_continuous", 8 + 2 * 4),
                                           ("p2e_dv2", 8 + 2 * 4), ("p2e_dv3_L_bf16", 8 + 2 * 4)])
def test_graphed_p2e_train_burst_equals_the_eager_steps(cuda, monkeypatch, algo, per_step):
    """The P2E exploration step (six updates) as the DV2 and DV3 ones above:
    eager steps against one burst of replays at the same state, batches,
    noise and τ schedule, with cuDNN's deterministic algorithms; T + 2 ×
    horizon cell launches a step on both (two imaginations). The L DIAMBRA
    preset runs at its ``bf16-mixed``, every launch on the cell's bf16
    operand path."""
    import importlib

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    from sheeprl_tpu_torch.tools import bench_dreamer
    from sheeprl_tpu_torch.train.burst import run_train_burst, tau_schedule
    from sheeprl_tpu_torch.train.graphs import WARMUP_CALLS

    family, _exp, _obs, actions, continuous, *_ = bench_dreamer.PRESETS[algo]
    train = importlib.import_module(bench_dreamer.ALGOS[family][1])
    n = WARMUP_CALLS + GRAPH_REPLAYS
    taus = tau_schedule(n, 0, 1, tau=0.02, first_hard=True) if "dv3" in algo else tau_schedule(n, 0, 3)
    small = {**GRAPH_SMALL_DV3, "algo.ensembles.n": 3}
    build = lambda: bench_dreamer.build_trainer(cuda, seed=0, algo=algo, **small)  # noqa: E731
    cfg, _state, _program, data = build()
    T, B = data["rewards"].shape[:2]
    gen = torch.Generator(device=cuda).manual_seed(1)
    noise = [train.draw_noise(cfg, actions, T, B, gen, cuda, continuous) for _ in range(n)]
    stack = {k: torch.stack([torch.roll(v, i, dims=1) for i in range(n)]) for k, v in data.items()}
    out = {}
    for fused in (False, True):
        _cfg, state, program, _data = build()
        before = ops.hafner_cell_launches.count
        metrics = [run_train_burst(program, state, {k: v[i : i + 1] for k, v in stack.items()}, taus[i : i + 1],
                                   noise=noise[i : i + 1], fused=fused) for i in range(n)]
        launches = ops.hafner_cell_launches.count - before
        params = [p.detach().clone() for m in state.values() if isinstance(m, torch.nn.Module) for p in m.parameters()]
        out[fused] = (metrics, params, launches)
    (em, ep, el), (gm, gp, gl) = out[False], out[True]
    assert el == gl == n * per_step
    for g, e in zip(gm, em):
        for k in e:
            assert abs(g[k] - e[k]) <= GRAPH_TOL * max(abs(e[k]), 1e-30), (k, g[k], e[k])
    for g, e in zip(gp, ep):
        assert (g - e).abs().max() <= GRAPH_TOL * e.abs().max().clamp_min(1e-30)
    if algo.endswith("_bf16"):
        assert ops.hafner_cell_launches.by_variant.get("bf16", 0) >= 2 * n * per_step


# the L and XL widths in f32 (no bias, eps 1e-3), with the kernel at 0.05 as chip_smoke.py draws it: K = H + X
# reaches 5120, and the 3xTF32 product's error against f32 grows with K (the forward reads 6e-5 at XL)
LARGE_CELLS = [(2048, 768), (4096, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("H,X", LARGE_CELLS, ids=["L", "XL"])
@pytest.mark.parametrize("B", [1, 16, 1024])
def test_cell_at_l_xl_shapes_with_gradients(cuda, B, H, X):
    """The forward and the hand VJP's five gradients against autograd of the
    plain version at the L and XL widths (acting, posterior, imagination)."""
    args = _operands(B, H, X, bias=False, layer_norm=True, device=cuda, seed=B + H)
    args = (args[0], args[1], 0.5 * args[2], *args[3:])  # the kernel at scale 0.05
    cot = torch.randn(B, H, device=cuda, generator=torch.Generator(device=cuda).manual_seed(B))
    before = ops.hafner_cell_launches.by_variant.get("f32", 0)
    out, got = _grads(lambda *a: ops.hafner_gru_cell(*a, eps=1e-3), args, cot)
    assert ops.hafner_cell_launches.by_variant["f32"] == before + 1
    plain, want = _grads(lambda *a: reference.hafner_cell(*a, eps=1e-3), args, cot)
    assert len(got) == len(want) == 5
    assert (out - plain).abs().max().item() <= TOL
    _assert_grads_close(got, want)


# the bf16 operand path against the plain bf16 cell: the same roundings of h, x and W, f32 accumulation, so the
# forward within TOL (the f32 summation order); what flows back through a rounding to bf16 (dx, the product's part of
# dh, dW) can land one bf16 ulp apart, at most 2^-7 of the value
BF16_GRAD_TOL = 2.0**-7
BF16_CELLS = [(1024, 768), (512, 512), (37, 20)]


@pytest.mark.cuda
@pytest.mark.parametrize("H,X", BF16_CELLS, ids=["p2e_L", "dv3", "odd"])
@pytest.mark.parametrize("B", [1, 16, 70, 1024])
def test_bf16_cell_matches_the_plain_bf16_cell(cuda, B, H, X):
    """x in bf16: the kernel's bf16 variant (``wgmma ... .bf16``) against the
    plain bf16 cell, forward and the five gradients; the new h is f32, dx
    bf16."""
    h, x, w, b, s, lb = _operands(B, H, X, bias=False, layer_norm=True, device=cuda, seed=B + X)
    args = (h, x.to(torch.bfloat16), 0.5 * w, b, s, lb)
    assert "bf16" in ops.hafner_cell_variant(B, H, X, dtype=torch.bfloat16)["product"]
    cot = torch.randn(B, H, device=cuda, generator=torch.Generator(device=cuda).manual_seed(B))
    before = ops.hafner_cell_launches.by_variant.get("bf16", 0)
    out, got = _grads(lambda *a: ops.hafner_gru_cell(*a, eps=1e-3), args, cot)
    assert ops.hafner_cell_launches.by_variant["bf16"] == before + 1
    plain, want = _grads(lambda *a: reference.hafner_cell(*a, eps=1e-3), args, cot)
    assert out.dtype == torch.float32 and got[1].dtype == torch.bfloat16 and len(got) == 5
    assert (out - plain).abs().max().item() <= TOL
    for g, w_ in zip(got, want):
        assert ((g.float() - w_.float()).abs().max() / w_.float().abs().max().clamp_min(1e-30)).item() <= BF16_GRAD_TOL


@pytest.mark.cuda
def test_p2e_finetuning_on_the_card_switches_between_two_captured_acting_steps(cuda, tmp_path):
    """A tiny P2E-DV3 exploration run and its finetuning through the CLI on
    the card: the finetuning player's two actors each replay their own
    captured acting step, and the cell launches once an acting step, T +
    horizon a gradient step and once a test step."""
    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.train.graphs import WARMUP_CALLS

    tiny = [
        "env=dummy", "env.id=discrete_dummy", "env.num_envs=2", "env.sync_env=True", "metric.log_level=0",
        "buffer.memmap=False", "per_rank_batch_size=2", "per_rank_sequence_length=4", "algo.horizon=2",
        "algo.dense_units=8", "algo.mlp_layers=1", "algo.train_every=2", "algo.ensembles.n=2",
        "algo.world_model.encoder.cnn_channels_multiplier=2", "algo.world_model.recurrent_model.recurrent_state_size=8",
        "algo.world_model.transition_model.hidden_size=8", "algo.world_model.representation_model.hidden_size=8",
        "algo.world_model.stochastic_size=4", "algo.world_model.discrete_size=4", "buffer.size=64",
        f"root_dir={tmp_path}",
    ]
    expl = cli.run(tiny + ["exp=p2e_dv3_exploration", "total_steps=24", "algo.learning_starts=12", "run_name=e"])
    before = ops.hafner_cell_launches.count
    fntn = cli.run(tiny + ["exp=p2e_dv3_finetuning", "total_steps=32", "algo.learning_starts=16", "run_name=f",
                           f"checkpoint.exploration_ckpt_path={expl['checkpoint']}"])
    launches = ops.hafner_cell_launches.count - before
    assert fntn["player_steps_by_actor"] == [7, 9] and fntn["actor_switched_at"] == 8
    assert fntn["graphs"]["act"]["captured"] == 2
    assert fntn["graphs"]["act"]["eager_calls"] == 2 * WARMUP_CALLS
    assert launches == 16 + (4 + 2) * fntn["gradient_steps"] + fntn["test_steps"]


_GRAPH_IN_A_CYCLE = """
import contextlib, gc, sys
import torch
from sheeprl_tpu_torch.train.graphs import capture_guard

x = torch.ones(64, device="cuda")
gc.collect()
gc.set_threshold(1_000_000)  # no collection while the garbage is made
old = torch.cuda.CUDAGraph()
with torch.cuda.graph(old):
    y = x * 2
holder = {"graph": old}
holder["self"] = holder  # a reference cycle: only the collector frees it
del old, holder
graph = torch.cuda.CUDAGraph()
guard = capture_guard() if sys.argv[1] == "guarded" else contextlib.nullcontext()
try:
    with guard, torch.cuda.graph(graph, capture_error_mode="thread_local"):
        gc.set_threshold(1)  # the collector runs at the next allocations, as it may at any time of a capture
        junk = [[] for _ in range(1000)]
        y = x + 1
    graph.replay()
    torch.cuda.synchronize()
    print("CAPTURED", float(y.sum()))
except Exception as e:  # the capture's own failure is what this script reports
    print("FAILED", type(e).__name__, str(e).splitlines()[0])
"""


@pytest.mark.cuda
def test_capture_guard_keeps_a_collected_graph_from_invalidating_a_capture(cuda, tmp_path):
    """A CUDA graph left in a reference cycle and finalized by the garbage
    collector while another graph is captured invalidates that capture
    (``cudaErrorStreamCaptureInvalidated``): the failure a DreamerV3 run's
    capture met. Under ``train.graphs.capture_guard`` the same capture
    succeeds. Each case runs in a fresh interpreter."""
    import os
    import subprocess
    import sys

    script = tmp_path / "graph_in_a_cycle.py"
    script.write_text(_GRAPH_IN_A_CYCLE)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = {}
    for case in ("unguarded", "guarded"):
        run = subprocess.run([sys.executable, str(script), case], capture_output=True, text=True, env=env, timeout=300)
        assert run.returncode == 0, run.stderr[-2000:]
        out[case] = run.stdout.strip().splitlines()[-1]
    assert out["unguarded"].startswith("FAILED") and "capture" in out["unguarded"], out
    assert out["guarded"] == "CAPTURED 128.0", out


# DreamerV1 at a small width: its flax GRU cell is PyTorch operations (no kernel), so no DV1 path launches the cell
GRAPH_SMALL_DV1 = {
    "algo.dense_units": 32, "algo.mlp_layers": 1, "algo.world_model.encoder.cnn_channels_multiplier": 4,
    "algo.world_model.recurrent_model.recurrent_state_size": 64, "algo.world_model.stochastic_size": 8,
    "algo.world_model.transition_model.hidden_size": 32, "algo.world_model.representation_model.hidden_size": 32,
    "algo.horizon": 4, "per_rank_batch_size": 4, "per_rank_sequence_length": 8,
}


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["dreamer_v1", "dreamer_v1_continuous", "p2e_dv1"])
def test_graphed_dv1_train_burst_equals_the_eager_steps(cuda, monkeypatch, algo):
    """DreamerV1's step (and P2E-DV1's exploration step) as the DV2 and DV3
    ones above: eager steps against one burst of replays at the same state,
    batches and noise, with cuDNN's deterministic algorithms; no cell
    launch on either."""
    import importlib

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    from sheeprl_tpu_torch.tools import bench_dreamer
    from sheeprl_tpu_torch.train.burst import run_train_burst
    from sheeprl_tpu_torch.train.graphs import WARMUP_CALLS

    family, _exp, _obs, actions, continuous, *_ = bench_dreamer.PRESETS[algo]
    train = importlib.import_module(bench_dreamer.ALGOS[family][1])
    n = WARMUP_CALLS + GRAPH_REPLAYS
    small = {**GRAPH_SMALL_DV1, **({"algo.ensembles.n": 3} if algo.startswith("p2e") else {})}
    build = lambda: bench_dreamer.build_trainer(cuda, seed=0, algo=algo, **small)  # noqa: E731
    cfg, _state, _program, data = build()
    T, B = data["rewards"].shape[:2]
    gen = torch.Generator(device=cuda).manual_seed(1)
    noise = [train.draw_noise(cfg, actions, T, B, gen, cuda, continuous) for _ in range(n)]
    stack = {k: torch.stack([torch.roll(v, i, dims=1) for i in range(n)]) for k, v in data.items()}
    out = {}
    for fused in (False, True):
        _cfg, state, program, _data = build()
        before = ops.hafner_cell_launches.count
        metrics = [run_train_burst(program, state, {k: v[i : i + 1] for k, v in stack.items()}, [0.0],
                                   noise=noise[i : i + 1], fused=fused) for i in range(n)]
        params = [p.detach().clone() for m in state.values() if isinstance(m, torch.nn.Module) for p in m.parameters()]
        out[fused] = (metrics, params, ops.hafner_cell_launches.count - before)
        if fused:
            assert program.static.step.graph is not None and program.static.step.replays == GRAPH_REPLAYS
    (em, ep, el), (gm, gp, gl) = out[False], out[True]
    assert el == gl == 0
    for g, e in zip(gm, em):
        for k in e:
            assert abs(g[k] - e[k]) <= GRAPH_TOL * max(abs(e[k]), 1e-30), (k, g[k], e[k])
    for g, e in zip(gp, ep):
        assert (g - e).abs().max() <= GRAPH_TOL * e.abs().max().clamp_min(1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 50, 2500])
def test_gru_cell_on_the_card_matches_the_cpu(cuda, B):
    """DreamerV1's GRU cell (PyTorch operations) on CUDA tensors against the
    same module on the CPU, TF32 off (the ``cuda`` fixture): forward and the
    gradients of the input, the state and every projection, within TOL of
    each tensor's largest magnitude."""
    from sheeprl_tpu_torch.models import GRUCell

    torch.manual_seed(B)
    cpu_cell = GRUCell(400, 200)
    card_cell = GRUCell(400, 200, device=cuda)
    card_cell.load_state_dict(cpu_cell.state_dict())
    x, h = torch.randn(B, 400), torch.randn(B, 200)
    outs = {}
    for name, cell, dev in (("cpu", cpu_cell, "cpu"), ("card", card_cell, cuda)):
        xd, hd = x.detach().to(dev).requires_grad_(), h.detach().to(dev).requires_grad_()
        out = cell(xd, hd)
        out.square().sum().backward()
        outs[name] = [out.detach().cpu(), xd.grad.cpu(), hd.grad.cpu()] + [p.grad.cpu() for p in cell.parameters()]
    before = ops.hafner_cell_launches.count
    for got, want in zip(outs["card"], outs["cpu"]):
        assert (got - want).abs().max() <= TOL * want.abs().max().clamp_min(1.0)
    assert ops.hafner_cell_launches.count == before


@pytest.mark.cuda
def test_dv1_cli_run_on_the_card_launches_no_cell_and_serves_its_checkpoint(cuda, tmp_path):
    """``exp=dreamer_v1`` through the CLI on ``cuda``: gradient steps and
    acting steps replayed from their graphs, 0 cell launches on the run and
    on serving its checkpoint, whose served actions equal a second load's."""
    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.ckpt import validate_checkpoint
    from sheeprl_tpu_torch.serve.model import load_gateway_model

    tiny = [f"{k}={v}" for k, v in GRAPH_SMALL_DV1.items()]
    ops.hafner_cell_launches.reset()
    result = cli.run(["exp=dreamer_v1", "env=dummy", "env.id=discrete_dummy", "env.num_envs=2", "env.sync_env=True",
                      "buffer.size=256", "total_steps=64", "algo.learning_starts=32", "algo.train_every=4",
                      "algo.per_rank_gradient_steps=1", f"root_dir={tmp_path}", "run_name=dv1"] + tiny)
    assert result["gradient_steps"] > 3 and result["player_steps"] > 3
    assert result["graphs"]["train"]["replays"] > 0 and result["graphs"]["act"]["replays"] > 0
    assert ops.hafner_cell_launches.count == 0
    ckpt = result["checkpoint"]
    assert validate_checkpoint(ckpt, deep=True)["framework"] == "torch"
    frames = {"rgb": np.random.RandomState(0).randint(0, 256, (3, 3, 64, 64)).astype(np.uint8)}
    acted = []
    for _ in range(2):
        model, *_ = load_gateway_model(ckpt)
        assert model.device.type == "cuda" and model.algo == "dreamer_v1"
        acted.append(model.act(frames, model.init_state_rows(3), torch.Generator(device="cuda").manual_seed(0)))
    np.testing.assert_array_equal(acted[0][0], acted[1][0])
    assert ops.hafner_cell_launches.count == 0

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``sheeprl_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. card: name and power limit (``nvidia-smi``) and ``torch.cuda.get_device_name``;
2. build: every CUDA source of the port, one ``nvcc`` each, started together;
3. kernels: each kernel against its plain PyTorch version on the card, with
   TF32 off; error, tolerance, and device time per call (20 calls captured
   in one CUDA graph, CUDA events around each of 50 replays queued behind a
   busy stream, median) beside the plain version's and the bound, and the
   product variant each shape launches:
   - the cell at the serving shapes (also eager time per call: events
     around each of 200 calls, host launch gaps included);
   - the cell at the training shapes (B=32, 801, 1600), with the hand VJP's
     six gradients against autograd of the plain version;
   - at B=32, 64 and 1600 the cell's time split into its product kernel and
     its gate kernel (the profiler's kernel records, ``tools/bench_cell.py``)
     beside cuBLAS's f32 SGEMM of the same product ``[h|x]·W``
     (``torch.matmul``, TF32 off): the yardstick, never called by the port;
   - the sequence at SEQUENCE_SHAPES (the kernel bench's, an odd one, B=64,
     and one past the persistent recurrence's limits): the variant the plan
     picks, forward and gradients against the plain loop; then each variant
     that fits launched by name, with its device launches per call and its
     time split into input projection and recurrence (profiler kernel
     records), and the persistent recurrence's synchronisation alone a step;
4. slice: a DreamerV2 agent at the full MsPacman width (rgb 3x64x64,
   channels 48/96/192/384, dense 400, recurrent 600, 32x32 latent, 9
   actions), seeded random weights, behind the port's ``ServeGateway`` with
   ``max_batch=64``; 64 clients x 16 lockstep requests of seeded uint8
   frames, then the same requests again through a gateway whose recurrent
   cell runs the plain version, which must give the same actions;
5. bench_kernels: the port's ``tools/bench_kernels.py`` (forward and
   backward of the sequence, kernel against the plain loop);
6. train: the DreamerV2 trainer at the full MsPacman width (B=32, T=50,
   horizon 15): one step at fixed weights and noise on the kernel path and
   on the plain-cell path, TF32 off, whose losses and gradient norms must
   agree; then one warm-up step and TRAIN_STEPS timed steps with every loss
   finite and exactly 65 cell launches a step (50 posterior steps at B=32,
   15 imagination steps at B=1600), and a profiled window of as many steps.

Each path's launch counts are zeroed just before its run and read just
after it: the served run (phase 4), the bench (phase 5) and the timed train
steps (phase 6). The build phase also counts the tensor-core instructions
(``HGMMA``, ``HMMA``) in the built library's SASS (``cuobjdump -sass``).

Bounds: the least time of the same work on an H100 SXM, the larger of its
bytes (each input read once, each output written once) at 3.35 TB/s and its
operations, the product ``[h|x]·W`` at f32 accuracy on the tensor cores
(three TF32 passes at 495 TFLOP/s) plus the LayerNorm and gates at the f32
rate (67 TFLOP/s). ``bound_f32_simt_ms`` keeps the earlier convention (the
whole product at 67 TFLOP/s), so that older rows stay comparable.

The last lines are the card line, one JSON line with a record per kernel,
and ``{"ok": true, "device": {...}}``. Exits non-zero, without that last
line, when there is no CUDA device or any phase fails.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

TOL_KERNEL = 1e-4  # abs: 3xTF32 on the tensor cores against f32, another summation order over K=1000
TOL_STATE = 1e-3  # abs: recurrent state after 16 chained steps, kernel vs plain cell
TOL_SEQUENCE = 1e-4  # abs: hs over T chained steps (the JAX suite's sequence tolerance is rtol 1e-4)
TOL_GRAD = 1e-4  # relative to each gradient's largest magnitude: f32, other summation orders
# kernel path against plain-cell path, one full-width train step at fixed weights and noise (TF32
# off): relative, losses and gradient global norms. Read on the card: losses equal to the last f32
# bit, gradient norms within 1.1e-7. These norms are dominated by the decoder and heads, so a wrong
# gradient of one of the cell's small leaves would not show here: phase_cell_training checks each of
# the cell's six gradients against autograd of the plain version
TOL_TRAIN_LOSS = 1e-5
TOL_TRAIN_GRAD = 1e-4
TRAIN_STEPS = 4
CELL_LAUNCHES_PER_STEP = 65  # 50 posterior steps + 15 imagination steps
# (T, B, H, X, bias, LayerNorm, eps, the variant the plan must pick): the kernel bench's shape; an odd
# one (last unit group of 11 units, scalar copies, no bias, no LayerNorm); the widest batch the
# persistent recurrence takes; one past its limits (W[:H]'s hi/lo slices do not fit on chip)
SEQUENCE_SHAPES = (
    (50, 16, 600, 400, True, True, 1e-3, "persistent"),
    (7, 5, 599, 37, False, False, 1e-3, "persistent"),
    (50, 64, 600, 400, True, True, 1e-3, "persistent"),
    (8, 16, 2048, 512, True, True, 1e-3, "multi_launch"),
)
SYNC_FLOOR_STEPS = 100
CLIENTS, STEPS, SEED = 64, 16, 5
N_ACTIONS = 9
OBS = {"rgb": (3, 64, 64)}
# NVIDIA H100 SXM data sheet: f32 outside the tensor cores, TF32 on them (dense), HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
TF32_PASSES = 3  # hi.hi + hi.lo + lo.hi: f32 accuracy from TF32 operands
PEAK_HBM_BYTES = 3.35e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _median_event_ms(run, n: int) -> float:
    import torch

    pairs = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def call_ms(fn, n: int = 200, warmup: int = 20) -> float:
    """Median time of one eager call as a caller pays it: an event pair
    around each of ``n`` back-to-back calls (host launch gaps included)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    return _median_event_ms(fn, n)


def device_ms(fn, calls: int = 20, n: int = 50) -> float:
    """Median device time of one call: ``calls`` back-to-back calls of
    ``fn`` captured in one CUDA graph, an event pair around each of ``n``
    replays, divided by ``calls``. Before each replay the stream is kept
    busy (``torch.cuda._sleep``) so that the start event runs only after the
    host has queued the graph: the host's launch cost stays out of the
    measurement. The operands stay in the 50 MB L2 from call to call."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()

    pairs = []
    for _ in range(n):
        torch.cuda._sleep(1_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs) / calls


def _bound(bytes_: float, product_flops: float, other_flops: float):
    """``(bound_ms, bound_by, bound_f32_simt_ms)``: the larger of the bytes
    at the HBM rate and the operations (the product in TF32_PASSES passes on
    the tensor cores, the rest at the f32 rate); and the earlier convention,
    every operation at the f32 rate."""
    t_bytes = bytes_ / PEAK_HBM_BYTES
    t_ops = TF32_PASSES * product_flops / PEAK_TF32_FLOPS + other_flops / PEAK_F32_FLOPS
    t_simt = (product_flops + other_flops) / PEAK_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), 1e3 * max(t_bytes, t_simt)


def hafner_bound(B: int, H: int, X: int, bias: bool, ln: bool):
    """Least time for one step (``_bound``): each input read once and the
    output written once, or the operations."""
    n_vec = 3 * H * (int(bias) + 2 * int(ln))
    bytes_ = 4.0 * (B * H + B * X + (H + X) * 3 * H + n_vec + B * H)
    other = (8.0 * B * 3 * H if ln else 0.0) + 10.0 * B * H
    return _bound(bytes_, 2.0 * B * (H + X) * 3 * H, other)


def phase_kernels():
    import numpy as np
    import torch

    from sheeprl_tpu_torch.kernels import ops, reference

    # the served widths at the batch sizes of one client, a part-filled and a
    # full batch; then odd widths without bias and LayerNorm (scalar copies)
    cases = [(B, 600, 400, True, True) for B in (1, 16, 64)] + [(B, 599, 37, False, False) for B in (1, 5, 64)]
    rows = []
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for B, H, X, bias, ln in cases:
            rng = np.random.RandomState(B * 1000 + H)
            t = lambda *shape, scale=1.0: torch.from_numpy(
                (scale * rng.randn(*shape)).astype(np.float32)
            ).cuda()
            h, x, w = t(B, H), t(B, X), t(H + X, 3 * H, scale=0.05)
            b = t(3 * H, scale=0.1) if bias else None
            s = (1.0 + t(3 * H, scale=0.1)) if ln else None
            lb = t(3 * H, scale=0.1) if ln else None
            out = ops.hafner_cell_cuda(h, x, w, b, s, lb, eps=1e-5)
            torch.cuda.synchronize()
            plain = reference.hafner_cell(h, x, w, b, s, lb, eps=1e-5)
            err = (out - plain).abs().max().item()
            ok = bool(torch.isfinite(out).all().item()) and err <= TOL_KERNEL
            kernel = lambda: ops.hafner_cell_cuda(h, x, w, b, s, lb, eps=1e-5)
            plain_fn = lambda: reference.hafner_cell(h, x, w, b, s, lb, eps=1e-5)
            bound_ms, bound_by, simt_ms = hafner_bound(B, H, X, bias, ln)
            row = dict(B=B, H=H, X=X, bias=bias, ln=ln, max_abs_err=err, tol=TOL_KERNEL,
                       ms=device_ms(kernel), plain_ms=device_ms(plain_fn),
                       call_ms=call_ms(kernel), plain_call_ms=call_ms(plain_fn),
                       bound_ms=bound_ms, bound_by=bound_by, bound_f32_simt_ms=simt_ms,
                       variant=ops.hafner_cell_variant(B, H, X))
            if (B, H, X) == (64, 600, 400):
                row.update(product_split((h, x, w, b, s, lb), B))
            print("[kernel] hafner_cell " + json.dumps(row), flush=True)
            rows.append(row)
            if not ok:
                raise AssertionError(f"hafner_cell disagrees with its plain version: {row}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    return rows


def sequence_bound(T: int, B: int, H: int, X: int, bias: bool, ln: bool):
    """Least time for a whole sequence (``_bound``): xs, h0, W and the
    vectors read once and hs written once, or T steps of operations."""
    n_vec = 3 * H * (int(bias) + 2 * int(ln))
    bytes_ = 4.0 * (B * H + T * B * X + (H + X) * 3 * H + n_vec + T * B * H)
    other = T * ((8.0 * B * 3 * H if ln else 0.0) + 10.0 * B * H)
    return _bound(bytes_, T * 2.0 * B * (H + X) * 3 * H, other)


def saved_z_error(args) -> dict:
    """The pre-activation the cell keeps for its gradient against float64,
    beside cuBLAS's f32 product of the same ``[h|x]·W + b`` (TF32 off): the
    3xTF32 product's error next to an f32 FMA chain's."""
    import torch

    from sheeprl_tpu_torch.kernels import ops

    h, x, w, b = args[:4]
    _out, z = ops.hafner_cell_cuda(*args, eps=1e-5, save_z=True)
    u = torch.cat([h, x], dim=-1)
    z64 = u.double() @ w.double() + b.double()
    return {
        "z_max_abs": z64.abs().max().item(),
        "z_err_vs_f64": (z.double() - z64).abs().max().item(),
        "cublas_z_err_vs_f64": ((u @ w + b).double() - z64).abs().max().item(),
    }


def product_split(args, B: int) -> dict:
    """The cell's device time split into its product and gate kernels (the
    profiler's kernel records, as ``tools/bench_cell.py`` reads them), and
    cuBLAS's f32 SGEMM of the same ``[h|x]·W`` (``torch.matmul``, TF32 off),
    timed as every kernel here (``device_ms``). In ms."""
    import torch

    from sheeprl_tpu_torch.tools import bench_cell

    split = bench_cell.cell_split(args)
    u = torch.cat(args[:2], dim=-1)
    return {
        "product_ms": split["product_us"] / 1e3,
        "gates_ms": split["gates_us"] / 1e3,
        "cublas_product_ms": device_ms(lambda: torch.matmul(u, args[2])),
        "cublas_product_profiler_ms": split["cublas_product_us"] / 1e3,
        "product_tflops_tf32": TF32_PASSES * 2.0 * B * u.shape[1] * args[2].shape[1] / (split["product_us"] * 1e6),
    }


def _grad_rel_err(got, want) -> float:
    """Largest abs difference of any gradient over that gradient's largest
    magnitude (gradients of W sum over the batch, so their scale grows with B)."""
    return max(((g - w).abs().max() / w.abs().max().clamp_min(1e-30)).item() for g, w in zip(got, want))


def _operands(shape_seed: int, B: int, H: int, X: int, bias: bool, ln: bool, T: int = 0):
    import numpy as np
    import torch

    rng = np.random.RandomState(shape_seed)
    t = lambda *shape, scale=1.0, shift=0.0: torch.from_numpy(
        (shift + scale * rng.randn(*shape)).astype(np.float32)
    ).cuda()
    h = t(B, H)
    x = t(T, B, X) if T else t(B, X)
    w = t(H + X, 3 * H, scale=0.05)
    b = t(3 * H, scale=0.1) if bias else None
    s = t(3 * H, scale=0.1, shift=1.0) if ln else None
    lb = t(3 * H, scale=0.1) if ln else None
    cot = t(T, B, H) if T else t(B, H)  # the output cotangent of the gradient check
    return (h, x, w, b, s, lb), cot


def _vjp(fn, args, cot):
    """Gradients of <fn(*args), cot> with respect to every operand given."""
    import torch

    leaves = [a.detach().requires_grad_(True) if a is not None else None for a in args]
    out = fn(*leaves)
    present = [a for a in leaves if a is not None]
    return out.detach(), torch.autograd.grad(out, present, cot)


def phase_cell_training():
    """The cell at the training batch sizes (posterior B=32, an odd B, the
    imagination's B=1600): forward against the plain version, the hand VJP's
    six gradients against autograd of the plain version, both on the card."""
    import torch

    from sheeprl_tpu_torch.kernels import ops, reference

    rows = []
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for B in (32, 801, 1600):
            H, X = 600, 400
            args, cot = _operands(B + 7, B, H, X, True, True)
            kernel = lambda *a: ops.hafner_gru_cell(*a, eps=1e-5)
            plain = lambda *a: reference.hafner_cell(*a, eps=1e-5)
            out, grads = _vjp(kernel, args, cot)
            p_out, p_grads = _vjp(plain, args, cot)
            torch.cuda.synchronize()
            err = (out - p_out).abs().max().item()
            grad_err = _grad_rel_err(grads, p_grads)
            bound_ms, bound_by, simt_ms = hafner_bound(B, H, X, True, True)
            leaves = [a.detach().requires_grad_(True) for a in args]
            row = dict(B=B, H=H, X=X, eps=1e-5, max_abs_err=err, tol=TOL_KERNEL, grad_rel_err=grad_err,
                       grad_tol=TOL_GRAD, ms=device_ms(lambda: ops.hafner_cell_cuda(*args, eps=1e-5)),
                       plain_ms=device_ms(lambda: reference.hafner_cell(*args, eps=1e-5)),
                       fwd_bwd_ms=device_ms(lambda: torch.autograd.grad(kernel(*leaves), leaves, cot)),
                       plain_fwd_bwd_ms=device_ms(lambda: torch.autograd.grad(plain(*leaves), leaves, cot)),
                       bound_ms=bound_ms, bound_by=bound_by, bound_f32_simt_ms=simt_ms,
                       variant=ops.hafner_cell_variant(B, H, X))
            if B in (32, 1600):
                row.update(product_split(args, B))
            row.update(saved_z_error(args))
            print("[kernel] hafner_cell training " + json.dumps(row), flush=True)
            rows.append(row)
            if not (torch.isfinite(out).all() and err <= TOL_KERNEL and grad_err <= TOL_GRAD):
                raise AssertionError(f"hafner_cell at B={B} disagrees with its plain version: {row}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    return rows


def phase_sequence():
    """The sequence kernel at SEQUENCE_SHAPES: the variant its plan picks,
    forward and gradients against the plain loop under autograd, device
    time, bound and plain time; then each variant that fits launched by name
    (forward against the plain loop, device time, device launches per call
    and the time split into input projection and recurrence from the
    profiler's kernel records) and, where the persistent recurrence runs,
    its synchronisation alone a step (``ops.hafner_sync_floor_cuda``)."""
    import torch

    from sheeprl_tpu_torch.kernels import ops, reference
    from sheeprl_tpu_torch.tools import bench_kernels

    rows = []
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for T, B, H, X, bias, ln, eps, expected in SEQUENCE_SHAPES:
            args, cot = _operands(T + B + H, B, H, X, bias, ln, T=T)
            plan = ops.hafner_sequence_variant(T, B, H, X)
            if plan["variant"] != expected:
                raise AssertionError(f"the plan at T={T} B={B} H={H} X={X} picks {plan['variant']}, not {expected}")
            kernel = lambda *a: ops.hafner_gru_sequence(*a, eps=eps)
            plain = lambda *a: reference.hafner_sequence(*a, eps=eps)
            before = ops.hafner_sequence_launches.count
            before_variant = ops.hafner_sequence_launches.by_variant.get(expected, 0)
            out, grads = _vjp(kernel, args, cot)
            p_out, p_grads = _vjp(plain, args, cot)
            torch.cuda.synchronize()
            if (ops.hafner_sequence_launches.count != before + 1
                    or ops.hafner_sequence_launches.by_variant[expected] != before_variant + 1):
                raise AssertionError(f"hafner_gru_sequence did not launch its {expected} kernel exactly once")
            err = (out - p_out).abs().max().item()
            grad_err = _grad_rel_err(grads, p_grads)
            bound_ms, bound_by, simt_ms = sequence_bound(T, B, H, X, bias, ln)
            variants = {}
            for variant in ("persistent", "multi_launch") if expected == "persistent" else ("multi_launch",):
                hs = ops.hafner_sequence_cuda(*args, eps=eps, variant=variant)
                torch.cuda.synchronize()
                variants[variant] = {
                    "max_abs_err": (hs - p_out).abs().max().item(),
                    "ms": device_ms(lambda: ops.hafner_sequence_cuda(*args, eps=eps, variant=variant)),
                    **bench_kernels.sequence_split(args, variant, eps),
                }
            chosen = variants[expected]
            row = dict(T=T, B=B, H=H, X=X, bias=bias, ln=ln, eps=eps, max_abs_err=err, tol=TOL_SEQUENCE,
                       grad_rel_err=grad_err, grad_tol=TOL_GRAD, variant=expected,
                       ms=device_ms(lambda: ops.hafner_sequence_cuda(*args, eps=eps)),
                       plain_ms=device_ms(lambda: reference.hafner_sequence(*args, eps=eps)),
                       bound_ms=bound_ms, bound_by=bound_by, bound_f32_simt_ms=simt_ms,
                       device_launches_per_call=chosen["device_launches_per_call"],
                       projection_ms=chosen["projection_ms"], recurrence_ms=chosen["recurrence_ms"],
                       variants=variants, plan=plan)
            if expected == "persistent":
                floor_ms = device_ms(lambda: ops.hafner_sync_floor_cuda(B, H, SYNC_FLOOR_STEPS))
                row["sync_floor_us_per_step"] = 1e3 * floor_ms / SYNC_FLOOR_STEPS
            print("[kernel] hafner_sequence " + json.dumps(row), flush=True)
            rows.append(row)
            worst = max([err] + [v["max_abs_err"] for v in variants.values()])
            if not (torch.isfinite(out).all() and worst <= TOL_SEQUENCE and grad_err <= TOL_GRAD):
                raise AssertionError(f"hafner_sequence disagrees with its plain loop: {row}")
            if chosen["device_launches_per_call"] != plan["device_launches_per_call"]:
                raise AssertionError(f"the profiler counts {chosen['device_launches_per_call']} device launches "
                                     f"a call, the plan {plan['device_launches_per_call']}: {row}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    return rows


def serve_lockstep(model, frames, seed: int):
    """64 clients x STEPS lockstep requests through a fresh gateway; every
    step is one full batch, rows in client order. Returns actions [T, C],
    recurrent states [T, C, H] (host copies), wall seconds and the status."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch.serve import ServeClosed, ServeGateway

    gateway = ServeGateway(model, max_batch=CLIENTS, deadline_s=0.25, seed=seed)
    try:
        batcher = gateway.batcher
        ids = [gateway.client(f"client{c}").client_id for c in range(CLIENTS)]
        actions = np.zeros((len(frames), CLIENTS), np.int64)
        states = []
        t0 = time.perf_counter()
        for t, step in enumerate(frames):
            tickets = [batcher.submit(cid, {"rgb": step[c]}, reset=t == 0) for c, cid in enumerate(ids)]
            for c, ticket in enumerate(tickets):
                action, _version = batcher.wait(ticket, timeout=120.0)
                actions[t, c] = int(np.asarray(action).reshape(-1)[0])
            states.append(torch.cat([batcher.state_of(cid)["recurrent"] for cid in ids]).cpu())
        if model.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not gateway.drain(timeout=60.0):
            raise AssertionError("gateway did not drain")
        try:
            batcher.submit(ids[0], {"rgb": frames[0][0]})
            raise AssertionError("a drained gateway accepted a request")
        except ServeClosed:
            pass
        return actions, torch.stack(states), wall, gateway.status()
    finally:
        gateway.close()


def phase_slice(card: str):
    import numpy as np
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_agent
    from sheeprl_tpu_torch.configs import dreamer_v2_config
    from sheeprl_tpu_torch.kernels import ops
    from sheeprl_tpu_torch.serve import GatewayModel

    cfg = dreamer_v2_config()
    wm, actor = build_agent(cfg, (N_ACTIONS,), False, OBS, device="cuda")
    params = {"world_model": wm.state_dict(), "actor": actor.state_dict()}
    n_params = sum(p.numel() for p in list(wm.parameters()) + list(actor.parameters()))
    model = GatewayModel.from_params(params, cfg, OBS, (N_ACTIONS,), False, device="cuda", version=1)
    plain = GatewayModel.from_params(
        params, cfg, OBS, (N_ACTIONS,), False, device="cuda", version=1, plain_cell=True
    )
    rng = np.random.RandomState(SEED)
    frames = rng.randint(0, 256, (STEPS, CLIENTS) + OBS["rgb"]).astype(np.uint8)
    serve_lockstep(model, frames[:2], seed=SEED + 1)  # warm-up: cuDNN, allocator, kernel load

    ops.hafner_cell_launches.reset()
    ops.hafner_sequence_launches.reset()
    actions, states, wall, status = serve_lockstep(model, frames, seed=SEED)
    launches = ops.hafner_cell_launches.count
    seq_launches = ops.hafner_sequence_launches.count

    requests = CLIENTS * STEPS
    if status["failed_requests"] != 0 or status["requests"] != requests:
        raise AssertionError(f"served {status['requests']} requests, {status['failed_requests']} failed")
    if not ((actions >= 0) & (actions < N_ACTIONS)).all():
        raise AssertionError("an action is outside [0, 9)")
    if not torch.isfinite(states).all():
        raise AssertionError("a recurrent state is not finite")
    unchanged = (states[1:] == states[:-1]).all(dim=-1)
    if unchanged.any():
        raise AssertionError(f"{int(unchanged.sum())} client steps left the recurrent state unchanged")
    if launches != status["batches"] or launches == 0:
        raise AssertionError(f"hafner_cell launched {launches} times for {status['batches']} batches")
    if seq_launches != 0:
        raise AssertionError(f"the sequence kernel launched {seq_launches} times on the serving path")

    p_actions, p_states, _wall, p_status = serve_lockstep(plain, frames, seed=SEED)
    state_err = (states - p_states).abs().max().item()
    if p_status["failed_requests"] != 0 or not np.array_equal(actions, p_actions):
        raise AssertionError(f"kernel and plain paths disagree on {(actions != p_actions).sum()} actions")
    if state_err > TOL_STATE:
        raise AssertionError(f"recurrent state differs by {state_err} > {TOL_STATE}")
    lat = status["act_latency"]
    result = {
        "requests": requests,
        "clients": CLIENTS,
        "batches": status["batches"],
        "mean_batch_occupancy": status["mean_batch_occupancy"],
        "failed_requests": status["failed_requests"],
        "requests_per_s": requests / wall,
        "act_latency_p50_ms": lat["p50_ms"],
        "act_latency_p99_ms": lat["p99_ms"],
        "device_dispatch_p50_ms": status["stage_latency"]["device_dispatch"]["p50_ms"],
        "hafner_cell_launches": launches,
        "hafner_sequence_launches": seq_launches,
        "plain_replay_actions_equal": True,
        "plain_replay_state_max_abs_err": state_err,
        "state_tol": TOL_STATE,
        "params": n_params,
        "card": card,
    }
    print("[slice] " + json.dumps(result), flush=True)
    return {"hafner_cell": launches, "hafner_sequence": seq_launches}


def phase_bench_kernels():
    """The kernel bench's path: counts zeroed before it and read after it."""
    from sheeprl_tpu_torch.kernels import ops
    from sheeprl_tpu_torch.tools import bench_kernels

    ops.hafner_cell_launches.reset()
    ops.hafner_sequence_launches.reset()
    line = bench_kernels.run("cuda")
    launches = {"hafner_sequence": ops.hafner_sequence_launches.count, "hafner_cell": ops.hafner_cell_launches.count}
    by_variant = dict(ops.hafner_sequence_launches.by_variant)
    print("[bench_kernels] " + json.dumps({**line, "launches": launches, "sequence_launches_by_variant": by_variant}),
          flush=True)
    if launches["hafner_sequence"] == 0 or launches["hafner_cell"] != 0:
        raise AssertionError(f"the kernel bench launched {launches}")
    if by_variant != {line["variant"]: launches["hafner_sequence"]}:
        raise AssertionError(f"the kernel bench ran {by_variant}, its plan names {line['variant']}")
    if line["max_abs_err"] > TOL_SEQUENCE or line["grad_rel_err"] > TOL_GRAD:
        raise AssertionError(f"the kernel bench's kernel path disagrees with its plain path: {line}")
    return launches, line


def _train_step_once(plain_cell: bool):
    """One full-width step at fixed weights (seed 0) and fixed noise, at τ=1."""
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v2.agent import set_cell_impl
    from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import draw_noise
    from sheeprl_tpu_torch.kernels import ops
    from sheeprl_tpu_torch.tools import bench_dreamer

    cfg, state, train_step, data = bench_dreamer.build_trainer("cuda", seed=0)
    if plain_cell:
        set_cell_impl(state["world_model"], "plain")
    T, B = data["rewards"].shape[:2]
    noise = draw_noise(cfg, bench_dreamer.ACTIONS, T, B, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    before = ops.hafner_cell_launches.count
    metrics = {k: float(v) for k, v in train_step(state, data, noise=noise, tau=1.0).items()}
    launches = ops.hafner_cell_launches.count - before
    if launches != (0 if plain_cell else CELL_LAUNCHES_PER_STEP):
        raise AssertionError(f"the {'plain-cell' if plain_cell else 'kernel'} train step launched the cell {launches} times")
    del state, data, noise
    torch.cuda.empty_cache()
    return metrics, launches


def phase_train(card: str):
    import math

    import torch

    from sheeprl_tpu_torch.tools import bench_dreamer

    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        (kernel_m, kernel_n), (plain_m, plain_n) = _train_step_once(False), _train_step_once(True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    rel = {k: abs(kernel_m[k] - plain_m[k]) / max(abs(plain_m[k]), 1e-6) for k in kernel_m}
    bad = [k for k, r in rel.items() if r > (TOL_TRAIN_GRAD if k.startswith("Grads/") else TOL_TRAIN_LOSS)]
    bad += [k for k, v in kernel_m.items() if not math.isfinite(v)]
    print("[train] kernel vs plain cell, one step: " + json.dumps(
        {"kernel": kernel_m, "plain": plain_m, "rel_diff": rel, "tol_loss": TOL_TRAIN_LOSS, "tol_grad": TOL_TRAIN_GRAD,
         "cell_launches": {"kernel": kernel_n, "plain": plain_n}}
    ), flush=True)
    if bad:
        raise AssertionError(f"kernel and plain-cell train steps disagree on {bad}")

    result = bench_dreamer.run(steps=TRAIN_STEPS, device="cuda", profile=True)
    result["card"] = card
    print("[train] " + json.dumps(result), flush=True)
    if not all(math.isfinite(v) for v in result["losses"].values()):
        raise AssertionError(f"a loss is not finite: {result['losses']}")
    if result["hafner_cell_launches"] != CELL_LAUNCHES_PER_STEP * TRAIN_STEPS:
        raise AssertionError(f"the cell launched {result['hafner_cell_launches']} times in {TRAIN_STEPS} steps")
    if result["hafner_sequence_launches"] != 0:
        raise AssertionError("the sequence kernel ran on the train path")
    launches = {"hafner_cell": result["hafner_cell_launches"], "hafner_sequence": result["hafner_sequence_launches"]}
    return launches, max(rel.values())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs only on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sheeprl_tpu_torch.kernels import build

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}", flush=True)

    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"[build] {sorted(logs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            # register and spill counts, and C7520 (ptxas serialising a kernel's wgmmas)
            if any(key in line for key in ("Used ", "spill", "C7520")) or "error" in line.lower():
                print(f"[build] {name}: {line.strip()}", flush=True)

    sass = build.tensor_core_instructions("hafner_gru")
    print(f"[build] hafner_gru tensor-core instructions in SASS (cuobjdump -sass): {json.dumps(sass)}", flush=True)
    if not any(form.startswith("HGMMA") for form in sass):
        raise AssertionError("the built library has no HGMMA (wgmma) instruction")

    serve_rows = phase_kernels()
    train_rows = phase_cell_training()
    seq_rows = phase_sequence()
    # launches per kernel, read on each path's run with the counts zeroed just before it
    by_path = {"serve": phase_slice(card)}
    by_path["bench_kernels"], bench_line = phase_bench_kernels()
    by_path["train"], train_rel_diff = phase_train(card)

    cell_row = next(r for r in train_rows if r["B"] == 1600)
    seq_row = seq_rows[0]
    if {v for r in seq_rows for v in r["variants"]} != {"persistent", "multi_launch"}:
        raise AssertionError("the run did not launch both variants of the sequence")
    kernels = [
        {
            "name": "hafner_cell",
            "route": "cuda",
            "source": "sheeprl_tpu_torch/kernels/csrc/hafner_gru.cu",
            "replaces": "sheeprl_tpu/kernels/pallas_tpu.py:67",
            "launches": by_path["train"]["hafner_cell"],
            "max_abs_err": max(r["max_abs_err"] for r in serve_rows + train_rows),
            "ms": cell_row["ms"],
            "plain_ms": cell_row["plain_ms"],
            "bound_ms": cell_row["bound_ms"],
            "bound_by": cell_row["bound_by"],
            "library_ms": cell_row["cublas_product_ms"],
            "library": "cuBLAS f32 SGEMM of the product [h|x].W alone (torch.matmul, TF32 off)",
            "product_ms": cell_row["product_ms"],
            "gates_ms": cell_row["gates_ms"],
            "bound_f32_simt_ms": cell_row["bound_f32_simt_ms"],
            "variant": cell_row["variant"]["product"],
            "sass_tensor_core_instructions": sass,
            "shape": "B=1600 H=600 X=400 (imagination)",
            "launches_by_path": {path: counts["hafner_cell"] for path, counts in by_path.items()},
            "train_step_rel_diff_vs_plain": train_rel_diff,
        },
        {
            "name": "hafner_sequence",
            "route": "cuda",
            "source": "sheeprl_tpu_torch/kernels/csrc/hafner_gru.cu",
            "replaces": "sheeprl_tpu/kernels/pallas_tpu.py:79",
            "launches": by_path["bench_kernels"]["hafner_sequence"],
            "max_abs_err": max(r["max_abs_err"] for r in seq_rows),
            "ms": seq_row["ms"],
            "plain_ms": seq_row["plain_ms"],
            "bound_ms": seq_row["bound_ms"],
            "bound_by": seq_row["bound_by"],
            "library_ms": None,
            "bound_f32_simt_ms": seq_row["bound_f32_simt_ms"],
            "variant": seq_row["variant"],
            "device_launches_per_call": seq_row["device_launches_per_call"],
            "projection_ms": seq_row["projection_ms"],
            "recurrence_ms": seq_row["recurrence_ms"],
            "sync_floor_us_per_step": seq_row.get("sync_floor_us_per_step"),
            "ms_by_variant": {v: r["ms"] for v, r in seq_row["variants"].items()},
            "device_launches_by_variant": {v: r["device_launches_per_call"] for v, r in seq_row["variants"].items()},
            "bench_fwd_bwd_s": bench_line["seconds_per_call"],
            "shape": "T=50 B=16 H=600 X=400 (kernel bench)",
            "launches_by_path": {path: counts["hafner_sequence"] for path, counts in by_path.items()},
        },
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

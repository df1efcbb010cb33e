#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``sheeprl_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. card: name and power limit (``nvidia-smi``) and ``torch.cuda.get_device_name``;
2. build: every CUDA source of the port, one ``nvcc`` each, started together;
3. kernels: each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it, with TF32 off; error, tolerance, and
   device time per call (20 calls captured in one CUDA graph, CUDA events
   around each of 50 replays queued behind a busy stream, median) and eager
   time per call (events around each of 200 calls, host launch gaps
   included), beside the plain version's and the bound;
4. slice: a DreamerV2 agent at the full MsPacman width (rgb 3x64x64,
   channels 48/96/192/384, dense 400, recurrent 600, 32x32 latent, 9
   actions), seeded random weights, behind the port's ``ServeGateway`` with
   ``max_batch=64``; 64 clients x 16 lockstep requests of seeded uint8
   frames, then the same requests again through a gateway whose recurrent
   cell runs the plain version, which must give the same actions.

The kernels' launch counts are zeroed just before phase 4's served run and
read just after it. The last lines are the card line, one JSON line with a
record per kernel, and ``{"ok": true, "device": {...}}``. Exits non-zero,
without that last line, when there is no CUDA device or any phase fails.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

TOL_KERNEL = 1e-4  # abs: f32 against f32, another summation order over K=1000
TOL_STATE = 1e-3  # abs: recurrent state after 16 chained steps, kernel vs plain cell
CLIENTS, STEPS, SEED = 64, 16, 5
N_ACTIONS = 9
OBS = {"rgb": (3, 64, 64)}
# NVIDIA H100 SXM data sheet: f32 outside the tensor cores, HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
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


def hafner_bound(B: int, H: int, X: int, bias: bool, ln: bool):
    """Least time for one step: each input read once and the output written
    once, or the operations at the f32 peak, whichever is larger."""
    n_vec = 3 * H * (int(bias) + 2 * int(ln))
    bytes_ = 4.0 * (B * H + B * X + (H + X) * 3 * H + n_vec + B * H)
    flops = 2.0 * B * (H + X) * 3 * H + (8.0 * B * 3 * H if ln else 0.0) + 10.0 * B * H
    t_bytes, t_ops = bytes_ / PEAK_HBM_BYTES, flops / PEAK_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


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
            bound_ms, bound_by = hafner_bound(B, H, X, bias, ln)
            row = dict(B=B, H=H, X=X, bias=bias, ln=ln, max_abs_err=err, tol=TOL_KERNEL,
                       ms=device_ms(kernel), plain_ms=device_ms(plain_fn),
                       call_ms=call_ms(kernel), plain_call_ms=call_ms(plain_fn),
                       bound_ms=bound_ms, bound_by=bound_by)
            print("[kernel] hafner_cell " + json.dumps(row), flush=True)
            rows.append(row)
            if not ok:
                raise AssertionError(f"hafner_cell disagrees with its plain version: {row}")
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
    actions, states, wall, status = serve_lockstep(model, frames, seed=SEED)
    launches = ops.hafner_cell_launches.count

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
        "plain_replay_actions_equal": True,
        "plain_replay_state_max_abs_err": state_err,
        "state_tol": TOL_STATE,
        "params": n_params,
        "card": card,
    }
    print("[slice] " + json.dumps(result), flush=True)
    return launches


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
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"[build] {name}: {line.strip()}", flush=True)

    kernel_rows = phase_kernels()
    launches = phase_slice(card)

    main_row = next(r for r in kernel_rows if (r["B"], r["H"], r["X"]) == (64, 600, 400))
    kernels = [
        {
            "name": "hafner_cell",
            "route": "cuda",
            "source": "sheeprl_tpu_torch/kernels/csrc/hafner_gru.cu",
            "replaces": "sheeprl_tpu/kernels/pallas_tpu.py:67",
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in kernel_rows),
            "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": None,
        }
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The data-parallel path on one card (ROADMAP queue A item 7a).

Every test here needs an NVIDIA card and skips without one (the ``cuda``
marker). The file imports neither JAX nor the JAX package (its spawned
ranks import it), so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_ddp.py -q

- A world of one NCCL rank: DreamerV3's gradient step at the 100k
  MsPacman width (the batch cut to 2 x 8) graphed, its all-reduces captured
  in the step's graph, three warm-up calls and two replays: the state and
  the metrics bit for bit those of the same steps outside a world (cuDNN
  deterministic, TF32 off).
- Two gloo ranks sharing the card (their steps eager: gloo's collectives
  run on the host), as ``chip_smoke.py``'s ``ddp_gloo`` phase runs them
  (``phase_ddp_gloo``): DreamerV3 at the 100k width, each rank's batch cut
  to 4 x 16, two steps on each rank's own batch and noise; the ranks'
  states bitwise equal after each step, the cell's launches a rank as
  predicted, and the first step's metrics against the same two ranks on the
  CPU within the card-against-CPU limits (1e-5 relative for the losses,
  1e-4 for the rest), the card's ranks taking the CPU ranks'
  straight-through samples' choices.
"""

import hashlib

import pytest
import torch

from sheeprl_tpu_torch.parallel import spawn

OVERRIDES = {"per_rank_batch_size": 2, "per_rank_sequence_length": 8, "algo.world_model.optimizer.lr": 0.0}
STEPS = 5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic)
    _deterministic()
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic) = prev


def _deterministic():
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True


def _state_hashes(state) -> dict:
    out = {}
    for name in ("world_model", "actor", "critic", "target_critic"):
        for k, v in state[name].state_dict().items():
            out[f"{name}.{k}"] = hashlib.sha256(v.detach().cpu().contiguous().numpy().tobytes()).hexdigest()
    for name, opt in state["opt"].items():
        for i, entry in enumerate(opt.state.values()):
            for k, v in entry.items():
                if isinstance(v, torch.Tensor):
                    out[f"opt.{name}.{i}.{k}"] = hashlib.sha256(v.detach().cpu().numpy().tobytes()).hexdigest()
    out["moments"] = [float(v) for v in state["moments"].values()]
    return out


def graphed_steps(device="cuda") -> dict:
    """STEPS graphed DreamerV3 steps from seed 0 (the trainer's own noise)."""
    from sheeprl_tpu_torch.tools import bench_dreamer
    from sheeprl_tpu_torch.train.burst import run_train_burst, tau_schedule

    _deterministic()
    _cfg, state, program, data = bench_dreamer.build_trainer(device, seed=0, algo="dreamer_v3", **OVERRIDES)
    stack = {k: v[None] for k, v in data.items()}
    taus = tau_schedule(STEPS, 0, 1, tau=0.02, first_hard=True)
    metrics = [run_train_burst(program, state, stack, taus[i: i + 1]) for i in range(STEPS)]
    torch.cuda.synchronize()
    step = program.step
    return {"metrics": metrics, "hashes": _state_hashes(state),
            "graph": (step.eager_calls, step.replays, step.graph is not None, step.eager_backend)}


def _nccl_rank(fabric):
    return {"world": (fabric.world_size, fabric.backend), **graphed_steps()}


@pytest.mark.cuda
def test_a_one_rank_nccl_world_captures_its_all_reduces_bit_for_bit(cuda):
    (ranked,) = spawn(_nccl_rank, 1, backend="nccl", device_of_rank="cuda:0")
    alone = graphed_steps()
    assert ranked["world"] == (1, "nccl")
    assert ranked["graph"] == alone["graph"] == (3, STEPS - 3, True, None)
    assert ranked["metrics"] == alone["metrics"]
    assert ranked["hashes"] == alone["hashes"]


@pytest.mark.cuda
def test_two_gloo_ranks_on_one_card_match_the_same_ranks_on_the_cpu(cuda):
    """``chip_smoke.phase_ddp_gloo``: it raises on any failed check."""
    import chip_smoke

    paths = chip_smoke.phase_ddp_gloo(chip_smoke.card_line())
    want = 2 * chip_smoke.DDP_GLOO_STEPS * (chip_smoke.DDP_GLOO_OVERRIDES["per_rank_sequence_length"]
                                            + chip_smoke.DDP_GLOO_HORIZON)
    assert paths == {"ddp_gloo_dreamer_v3": {"hafner_cell": want, "hafner_sequence": 0}}

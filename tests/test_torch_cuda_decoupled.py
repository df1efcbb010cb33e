"""The actor–learner plane's decoupled entrypoints on the card.

Every test here needs an NVIDIA card and skips without one (the ``cuda``
marker). The file imports neither JAX nor the JAX package, so it runs where
only PyTorch is installed, from the repository's root (the runs' envs are
``chip_smoke``'s stand-ins: the card's machine has no gymnasium):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_decoupled.py -q

- a ``sac_decoupled`` and a ``ppo_decoupled`` dry run through the CLI, the
  learner on the card;
- a spawned player holds no CUDA context (``torch.cuda.is_initialized()``
  is false in it, as it reports at its exit);
- the TD residuals of SAC's graphed step (``emit_td``, the prioritized
  writeback's) equal the eager step's, bit for bit, with TF32 off.
"""

import numpy as np
import pytest
import torch

STEPS = 6  # 3 eager warm-up calls, the capture, 3 replays


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


_COMMON = ["fabric.devices=auto", "env.capture_video=False", "metric.log_level=0", "buffer.memmap=False",
           "algo.run_test=False", "checkpoint.every=100000000", "checkpoint.save_last=True"]
SAC = ["exp=sac_decoupled", "env.wrapper._target_=chip_smoke.pendulum_stand_in", "env.id=Pendulum-v1",
       "env.num_envs=2", "algo.hidden_size=32", "per_rank_batch_size=16", "buffer.size=1024"] + _COMMON
PPO = ["exp=ppo_decoupled", "env.wrapper._target_=chip_smoke.cartpole_stand_in", "env.id=CartPole-v1",
       "env.num_envs=2", "algo.rollout_steps=16", "per_rank_batch_size=16", "algo.update_epochs=2"] + _COMMON


def _run(tmp_path, monkeypatch, args, name):
    from sheeprl_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    return cli.run(args + [f"root_dir={tmp_path}/logs", f"run_name={name}"])


@pytest.mark.cuda
@pytest.mark.parametrize("base", [SAC, PPO], ids=["sac_decoupled", "ppo_decoupled"])
def test_a_decoupled_dry_run_trains_on_the_card(cuda, tmp_path, monkeypatch, base):
    result = _run(tmp_path, monkeypatch, base + ["dry_run=True"], "dry")
    assert result["updates"] == 1 and result["gradient_steps"] >= 1
    assert result["plane"]["slabs"] == 1 and result["plane"]["policy_version"] == 1
    assert result["checkpoint"] is not None


@pytest.mark.cuda
def test_a_spawned_player_holds_no_cuda_context(cuda, tmp_path, monkeypatch):
    torch.cuda.init()
    result = _run(tmp_path, monkeypatch, SAC + ["plane.num_players=2", "env.vectorization=async", "total_steps=64",
                                                "algo.learning_starts=16"], "players")
    assert result["updates"] == 32 and result["plane"]["players"] == 2
    assert result["plane"]["exits"] == {0: {"cuda_initialized": False}, 1: {"cuda_initialized": False}}
    assert torch.cuda.is_initialized()  # the learner's


@pytest.mark.cuda
def test_the_graphed_td_residuals_equal_the_eager_step(cuda):
    from sheeprl_tpu_torch.algos.sac import sac
    from sheeprl_tpu_torch.algos.sac.agent import build_agent_state
    from sheeprl_tpu_torch.config import compose

    obs, act, hidden, b = 5, 2, 32, 16
    cfg = compose(overrides=["exp=sac", f"algo.hidden_size={hidden}", f"per_rank_batch_size={b}"])

    def state():
        agent = build_agent_state(obs, act, hidden, hidden, 2, 1.0, torch.Generator().manual_seed(3), device=cuda)
        s = sac.build_optimizers_and_state(cfg, agent)
        s["action_scale"], s["action_bias"] = torch.ones(act, device=cuda), torch.zeros(act, device=cuda)
        return s

    graphed, eager = state(), state()
    program = sac.build_train_fn(cfg, act, -float(act), emit_td=True)
    eager_program = sac.build_train_fn(cfg, act, -float(act), emit_td=True)
    rng = np.random.RandomState(1)
    stack = {
        "observations": torch.as_tensor(rng.randn(STEPS, b, obs), dtype=torch.float32, device=cuda),
        "actions": torch.as_tensor(rng.uniform(-1, 1, (STEPS, b, act)), dtype=torch.float32, device=cuda),
        "rewards": torch.as_tensor(rng.randn(STEPS, b, 1), dtype=torch.float32, device=cuda),
        "dones": torch.as_tensor(rng.uniform(size=(STEPS, b, 1)) < 0.2, dtype=torch.float32, device=cuda),
        "next_observations": torch.as_tensor(rng.randn(STEPS, b, obs), dtype=torch.float32, device=cuda),
    }
    gen = torch.Generator(device=cuda).manual_seed(7)
    noises = [{k: torch.randn((b, act), generator=gen, device=cuda) for k in ("next", "actor")} for _ in range(STEPS)]
    gates = sac.ema_gates(True, float(cfg.algo.tau))
    metrics = program.burst(graphed, stack, gates, noise=noises)
    tds, eager_metrics = [], []
    for i in range(STEPS):
        m, td = eager_program(eager, {k: v[i] for k, v in stack.items()}, noises[i], gates)
        tds.append(td)
        eager_metrics.append(m)
    assert program.static.step.replays == 3
    assert program.last_td.shape == (STEPS, b, 1)
    assert torch.equal(program.last_td, torch.stack(tds))
    total = eager_metrics[0].clone()
    for m in eager_metrics[1:]:
        total.add_(m)
    assert torch.equal(metrics, total / STEPS)

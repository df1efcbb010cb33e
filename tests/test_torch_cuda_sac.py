"""The SAC family's captured steps and the rollout engine on the card.

Every test here needs an NVIDIA card and skips without one (the ``cuda``
marker). The file imports neither JAX nor the JAX package, so it runs where
only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_sac.py -q

Each test holds a graph replay against the eager call of the same function
on a twin state from the same seed, the same inputs and the same noise
(drawn outside the graph: a captured step holds no random number
generator), bit for bit, with TF32 off and cuDNN deterministic:

- the rollout engine's burst (the device Pendulum, SAC's actor acting, the
  ring's append and the auto-reset);
- a DroQ update (the G-step dropout critic loop and the actor in one graph,
  every dropout mask an input);
- a SAC-AE gradient step at each cadence (its gates are device values: one
  graph serves every cadence).
"""

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch.config import compose

STEPS = 6  # 3 eager warm-up calls, the capture, 3 replays


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic) = prev


def _params(state, names):
    return {f"{n}.{k}": v.detach().clone() for n in names for k, v in state[n].named_parameters()}


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.cuda
def test_the_engine_burst_graph_equals_the_eager_burst(cuda):
    from sheeprl_tpu_torch.algos.sac.agent import SACActor, lecun_normal_, squash_sample
    from sheeprl_tpu_torch.data.buffers import ReplayBuffer
    from sheeprl_tpu_torch.data.device_ring import DeviceRingTransitions
    from sheeprl_tpu_torch.envs.rollout import Pendulum, RolloutEngine

    n, burst = 4, 8
    actor = lecun_normal_(SACActor(3, 1, 32), torch.Generator().manual_seed(0)).to(cuda)
    scale, bias = torch.tensor([2.0], device=cuda), torch.tensor([0.0], device=cuda)

    def policy(obs, eps):
        mean, std = actor(obs)
        return squash_sample(mean, std, eps, scale, bias)[0]

    engines = []
    for _ in range(2):
        ring = DeviceRingTransitions(ReplayBuffer(64, n), cuda, torch.Generator(device=cuda).manual_seed(0))
        engine = RolloutEngine(Pendulum(n, cuda, max_episode_steps=10), torch.Generator(device=cuda).manual_seed(1),
                               policy=policy, ring=ring)
        engine.reset(engine.env.reset_noise(torch.Generator(device=cuda).manual_seed(2)))
        engines.append(engine)
    graphed, eager = engines
    for _ in range(STEPS):
        noise = graphed.draw_noise(burst, random_actions=False)
        noise = {k: v.clone() for k, v in noise.items()}
        stats = [s.clone() for s in graphed.collect(burst, noise=noise)]
        with torch.no_grad():
            want = eager._burst(burst, False, noise)
        eager.ring.advance(burst, eager.example_rows())
        for got, w in zip(stats, want):
            assert torch.equal(got, w)
    step = graphed.graphs[(burst, False)]
    assert (step.eager_calls, step.replays, step.graph is not None) == (3, 3, True)
    for k, v in graphed.ring.buffers.items():
        assert torch.equal(v, eager.ring.buffers[k]), k
    assert int(graphed.ring.pos) == int(eager.ring.pos) == (STEPS * burst) % 64
    assert bool(eager.ring.buffers["dones"].any())  # the 10-step episodes ended and were reset inside the bursts


def _droq(cuda):
    from sheeprl_tpu_torch.algos.droq import droq
    from sheeprl_tpu_torch.algos.sac import sac

    cfg = compose(overrides=["exp=droq", "algo.hidden_size=64", "per_rank_batch_size=32",
                             "algo.per_rank_gradient_steps=5", "algo.critic.dropout=0.1"])
    agent = droq.build_agent_state(8, 2, cfg, torch.Generator().manual_seed(0), cuda)
    state = sac.build_optimizers_and_state(cfg, agent)
    state["action_scale"] = torch.ones(2, device=cuda)
    state["action_bias"] = torch.zeros(2, device=cuda)
    return cfg, state, droq.build_train_fn(cfg, 2, -2.0)


@pytest.mark.cuda
def test_a_graphed_droq_update_with_its_dropout_equals_the_eager_update(cuda):
    from sheeprl_tpu_torch.algos.sac.sac import ema_gates

    (cfg, graphed, program), (_, eager, eager_program) = _droq(cuda), _droq(cuda)
    g, b = 5, 32
    rng = np.random.RandomState(0)
    stack = {
        "observations": rng.randn(STEPS, g, b, 8), "actions": rng.uniform(-1, 1, (STEPS, g, b, 2)),
        "rewards": rng.randn(STEPS, g, b, 1), "dones": (rng.uniform(size=(STEPS, g, b, 1)) < 0.1),
        "next_observations": rng.randn(STEPS, g, b, 8), "actor_observations": rng.randn(STEPS, b, 8),
    }
    stack = {k: torch.as_tensor(v, dtype=torch.float32, device=cuda) for k, v in stack.items()}
    gen = torch.Generator(device=cuda).manual_seed(5)
    noises = [program._draw_noise(graphed, {k: v[i] for k, v in stack.items()}, gen, cuda) for i in range(STEPS)]
    assert 0.85 < float(noises[0]["masks"].float().mean()) < 0.95
    gates = ema_gates(True, float(cfg.algo.tau))
    metrics = program.burst(graphed, stack, gates, noise=noises)
    for i in range(STEPS):
        want = eager_program(eager, {k: v[i] for k, v in stack.items()}, noises[i], gates)
    assert program.static.step.replays == 3 and program.static.step.graph is not None
    names = ("actor", "critics", "target_critics")
    _assert_same(_params(graphed, names), _params(eager, names))
    assert torch.equal(graphed["log_alpha"], eager["log_alpha"])
    assert torch.isfinite(metrics).all() and torch.isfinite(want).all()


def _sac_ae(cuda):
    from sheeprl_tpu_torch.algos.sac_ae import sac_ae
    from sheeprl_tpu_torch.algos.sac_ae.agent import build_agent
    from sheeprl_tpu_torch.envs import spaces

    cfg = compose(overrides=["exp=sac_ae", "algo.hidden_size=64", "algo.encoder.features_dim=16",
                             "algo.cnn_channels_multiplier=2", "algo.dense_units=16", "per_rank_batch_size=8"])
    space = spaces.Dict({"rgb": spaces.Box(0, 255, (9, 64, 64), np.uint8)})
    agent = build_agent(cfg, 2, space, torch.Generator().manual_seed(0), device=cuda)
    state = sac_ae.build_optimizers_and_state(cfg, agent)
    state["action_scale"] = torch.ones(2, device=cuda)
    state["action_bias"] = torch.zeros(2, device=cuda)
    return cfg, state, sac_ae.build_train_fn(cfg, 2, -2.0)


@pytest.mark.cuda
def test_a_graphed_sac_ae_step_equals_the_eager_step_at_every_cadence(cuda):
    from sheeprl_tpu_torch.algos.sac_ae import sac_ae

    (cfg, graphed, program), (_, eager, eager_program) = _sac_ae(cuda), _sac_ae(cuda)
    b = 8
    rng = np.random.RandomState(1)
    stack = {
        "rgb": torch.as_tensor(rng.randint(0, 256, (STEPS, b, 9, 64, 64)), dtype=torch.uint8, device=cuda),
        "next_rgb": torch.as_tensor(rng.randint(0, 256, (STEPS, b, 9, 64, 64)), dtype=torch.uint8, device=cuda),
        "actions": torch.as_tensor(rng.uniform(-1, 1, (STEPS, b, 2)), dtype=torch.float32, device=cuda),
        "rewards": torch.as_tensor(rng.randn(STEPS, b, 1), dtype=torch.float32, device=cuda),
        "dones": torch.zeros((STEPS, b, 1), device=cuda),
    }
    gen = torch.Generator(device=cuda).manual_seed(7)
    noises = [program._draw_noise(graphed, {k: v[i] for k, v in stack.items()}, gen, cuda) for i in range(STEPS)]
    cadences = [(True, True, True), (False, False, False), (True, False, True), (False, True, False),
                (True, True, False), (False, False, True)]
    gates = np.stack([sac_ae.cadence_gates(cfg, *c) for c in cadences])
    program.burst(graphed, stack, gates, noise=noises)
    for i in range(STEPS):
        eager_program(eager, {k: v[i] for k, v in stack.items()}, noises[i], gates[i])
    assert program.static.step.replays == 3
    names = ("encoder", "target_encoder", "qfs", "target_qfs", "actor", "decoder")
    _assert_same(_params(graphed, names), _params(eager, names))
    for name in ("actor", "decoder"):
        p = next(graphed[name].parameters())
        assert int(graphed["opt"][name].state[p]["step"]) == sum(c[1 if name == "actor" else 2] for c in cadences)

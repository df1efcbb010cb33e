"""The on-policy family's captured steps on the card.

Every test here needs an NVIDIA card and skips without one (the ``cuda``
marker). The file imports neither JAX nor the JAX package, so it runs where
only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_ppo.py -q

- A PPO update (the NatureCNN pixel path, 2 epochs × 2 minibatches),
  graphed against eager on a twin agent from the same seed, at the same
  permutations, with TF32 off and cuDNN deterministic: the metrics and the
  parameters bit for bit; likewise a PPO-recurrent update over sequences.
- The acting step (graph replays) against the eager policy at the same noise.
- GAE and the LSTM cell on the card against the CPU: atol 1e-6 and 1e-5.
"""

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch.config import compose


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


def _trainer(name, device, overrides):
    """A small-width trainer of ``name`` with one seeded rollout."""
    from types import SimpleNamespace

    from sheeprl_tpu_torch.algos.ppo.agent import build_agent
    from sheeprl_tpu_torch.algos.ppo.ppo import PPO, build_optimizer
    from sheeprl_tpu_torch.algos.ppo_recurrent.agent import build_agent as build_recurrent
    from sheeprl_tpu_torch.algos.ppo_recurrent.ppo_recurrent import RecurrentPPO
    from sheeprl_tpu_torch.envs import spaces

    cfg = compose(overrides=[f"exp={name}"] + overrides)
    pixels = name == "ppo"
    obs = {"rgb": (3, 64, 64)} if pixels else {"state": (4,)}
    space = spaces.Dict({k: spaces.Box(0, 255, s, np.uint8) if len(s) == 3 else spaces.Box(-np.inf, np.inf, s,
                                                                                             np.float32)
                         for k, s in obs.items()})
    cnn, mlp = list(cfg.cnn_keys.encoder), list(cfg.mlp_keys.encoder)
    build, family = (build_agent, PPO) if pixels else (build_recurrent, RecurrentPPO)
    agent = build(cfg, (3,), False, cnn, mlp, space, torch.Generator().manual_seed(0), device=device)
    run = SimpleNamespace(actions_dim=(3,), is_continuous=False, cnn_keys=cnn, obs_keys=mlp + cnn, generator=None)
    n = family.samples(cfg)
    program = family.make_program(cfg, agent, build_optimizer(cfg, agent), run, n, device)
    rng = np.random.RandomState(1)
    lead = (n,) if pixels else (int(cfg.per_rank_sequence_length), n)
    data = {k: rng.randint(0, 256, lead + s).astype(np.uint8) if len(s) == 3 else rng.randn(*lead, *s).astype(
        np.float32) for k, s in obs.items()}
    data["actions"] = np.eye(3, dtype=np.float32)[rng.randint(0, 3, lead)]
    for k in ("logprobs", "values", "returns", "advantages"):
        data[k] = rng.randn(*lead, 1).astype(np.float32)
    if not pixels:
        data["is_first"] = (rng.uniform(size=lead + (1,)) < 0.1).astype(np.float32)
        data["prev_actions"] = data["actions"] * (1.0 - data["is_first"])
        data["hc_c"], data["hc_h"] = (rng.randn(n, 8).astype(np.float32) for _ in range(2))
    perms = [np.random.RandomState(2 + e).permutation(n) for e in range(program.epochs)]
    return cfg, agent, program, data, perms


UPDATES = {
    "ppo": ["cnn_keys.encoder=[rgb]", "mlp_keys.encoder=[]", "algo.rollout_steps=32", "env.num_envs=2",
            "per_rank_batch_size=32", "algo.update_epochs=2", "algo.encoder.cnn_features_dim=64",
            "algo.normalize_advantages=True", "algo.max_grad_norm=0.5"],
    "ppo_recurrent": ["algo.rollout_steps=16", "env.num_envs=4", "per_rank_sequence_length=8", "per_rank_num_batches=2",
                      "algo.update_epochs=2", "algo.rnn.lstm.hidden_size=8", "mlp_keys.encoder=[state]"],
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(UPDATES))
def test_a_graphed_update_equals_the_eager_update(cuda, name):
    """Two updates of 4 minibatch steps each: the first 3 steps eager warm-up
    calls, then the capture and replays, against every step eager."""
    from sheeprl_tpu_torch.train.graphs import WARMUP_CALLS

    out = {}
    for eager in (True, False):
        cfg, agent, program, data, perms = _trainer(name, cuda, UPDATES[name])
        metrics = [program.update(data, [0.2, 0.01], perms=perms, eager=eager).cpu() for _ in range(2)]
        out[eager] = (metrics, {k: v.detach().cpu() for k, v in agent.named_parameters()}, program)
    for a, b in zip(out[True][0], out[False][0]):
        assert torch.equal(a, b)
    for k, v in out[True][1].items():
        assert torch.equal(v, out[False][1][k]), k
    step = out[False][2].step
    assert (step.eager_calls, step.replays, step.graph is not None) == (WARMUP_CALLS, 8 - WARMUP_CALLS, True)


@pytest.mark.cuda
def test_the_acting_graph_equals_the_eager_policy(cuda):
    from sheeprl_tpu_torch.algos.ppo.agent import PPOAgent, draw_noise, sample_actions
    from sheeprl_tpu_torch.algos.ppo.ppo import ActingGraph
    from sheeprl_tpu_torch.algos.ppo.utils import normalize_obs

    agent = PPOAgent((2, 3), False, (), ("state",), 0, 4, device=cuda)

    def policy(inputs, noise):
        pre, values = agent(normalize_obs(inputs, [], ["state"]))
        return (*sample_actions(pre, False, noise), values)

    rng = np.random.RandomState(0)
    obs = {"state": rng.randn(5, 4).astype(np.float32)}
    acting = ActingGraph(policy, obs, lambda g: draw_noise((2, 3), False, (5,), g, cuda), None, cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    for _ in range(6):
        obs = {"state": rng.randn(5, 4).astype(np.float32)}
        noise = draw_noise((2, 3), False, (5,), gen, cuda)
        got = acting(obs, noise)
        with torch.no_grad():
            want = policy({"state": torch.from_numpy(obs["state"]).to(cuda)}, noise)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.cpu().numpy())
    assert acting.step.replays == 6 - 3 and acting.step.graph is not None


@pytest.mark.cuda
def test_gae_and_the_lstm_cell_on_the_card_match_the_cpu(cuda):
    from sheeprl_tpu_torch.algos.ppo.ppo import GaeStep
    from sheeprl_tpu_torch.algos.ppo_recurrent.agent import ResetLSTM
    from sheeprl_tpu_torch.utils.utils import gae

    rng = np.random.RandomState(4)
    T, n = 64, 8
    args = [torch.from_numpy(rng.randn(T, n, 1).astype(np.float32)) for _ in range(2)]
    args.append(torch.from_numpy((rng.uniform(size=(T, n, 1)) < 0.1).astype(np.float32)))
    args.append(torch.from_numpy(rng.randn(n, 1).astype(np.float32)))
    want = gae(*args, 0.99, 0.95)
    step = GaeStep(0.99, 0.95, cuda)
    for _ in range(5):  # eager warm-up calls, the capture, replays
        got = step(*args)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=0, atol=1e-6)
    lstm = ResetLSTM(6, 16)
    x = torch.from_numpy(rng.randn(8, 5, 6).astype(np.float32))
    first = torch.from_numpy((rng.uniform(size=(8, 5, 1)) < 0.2).astype(np.float32))
    hc = tuple(torch.from_numpy(rng.randn(5, 16).astype(np.float32)) for _ in range(2))
    with torch.no_grad():
        out, (c, h) = lstm(x, first, hc)
        lstm.to(cuda)
        out_d, (c_d, h_d) = lstm(x.to(cuda), first.to(cuda), tuple(t.to(cuda) for t in hc))
    for a, b in ((out_d, out), (c_d, c), (h_d, h)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0, atol=1e-5)

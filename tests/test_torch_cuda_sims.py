"""The real-simulator wrappers and MineDojo's masked acting on the card.

Every test here needs an NVIDIA card and skips without one (the ``cuda``
marker). The file imports neither JAX nor the JAX package, so it runs where
only PyTorch is installed; the simulators are the stand-ins of
``tests/sim_stubs.py`` (duck-typed spaces, as the card's machine has no
gymnasium):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_sims.py -q

- the masked sampler and exploration noise on the card against the CPU at
  injected noise: every head's action equal, probabilities within 1e-6;
- a MineDojo and a MineRL wrapper over the stand-ins feeding DreamerV3's
  graphed acting step (``ExplorationStep``: its CUDA graph, MineDojo's masks
  among its inputs) at a small width, each step against the CPU player from
  the card's state before it at the same noise: actions equal, states within
  1e-3 (TOL_STATE of ``chip_smoke.py``), TF32 off; the stand-ins raise on an
  action outside their action space, and the MineDojo stand-in flags none
  of the masked player's actions as forbidden by its masks.
"""

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch.config import compose
import sim_stubs

TOL_STATE = 1e-3
STEPS = 36  # 3 eager warm-up calls, the capture, replays, and the end of every env's first episode (32 steps)
SMALL = ["algo.dense_units=32", "algo.mlp_layers=2", "algo.world_model.encoder.cnn_channels_multiplier=8",
         "algo.world_model.recurrent_model.recurrent_state_size=64", "algo.world_model.transition_model.hidden_size=32",
         "algo.world_model.representation_model.hidden_size=32", "algo.world_model.stochastic_size=8",
         "algo.world_model.discrete_size=8", "env.capture_video=False", "env.sync_env=True",
         "algo.actor.expl_amount=0.3"]
ENVS = {
    "minedojo": ["exp=dreamer_v3", "env=minedojo", "mlp_keys.encoder=[inventory,equipment,life_stats]"],
    "minerl": ["exp=dreamer_v3_L_navigate"],
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


@pytest.fixture
def stand_ins():
    mods = sim_stubs.install("minerl", "minedojo")
    try:
        yield mods
    finally:
        sim_stubs.uninstall("minerl", "minedojo")


@pytest.mark.cuda
def test_the_masked_sampler_on_the_card_matches_the_cpu(cuda):
    from sheeprl_tpu_torch.algos.dreamer_v3 import minedojo_actor as md
    from sheeprl_tpu_torch.distributions import gumbel_noise

    gen = torch.Generator().manual_seed(0)
    n, dims = 256, (19, 16, 60)
    logits = [torch.randn((n, d), generator=gen) * 2 for d in dims]
    masks = {"mask_action_type": torch.rand((n, 19), generator=gen) < 0.8,
             "mask_craft_smelt": torch.rand((n, 16), generator=gen) < 0.3,
             "mask_equip_place": torch.rand((n, 60), generator=gen) < 0.1,
             "mask_destroy": torch.rand((n, 60), generator=gen) < 0.1}
    masks["mask_action_type"][:, :12] = True
    masks["mask_craft_smelt"][::7] = False  # heads with no valid entry
    noise = [gumbel_noise((n, d), gen) for d in dims]
    expl = [(gumbel_noise((n, d), gen), torch.rand((n, 1), generator=gen)) for d in dims]
    out = {}
    for device in ("cpu", "cuda"):
        to = {k: v.to(device) for k, v in masks.items()}
        actions, dists = md.sample_minedojo_actions([x.to(device) for x in logits], to, 0.01, True,
                                                    noise=[g.to(device) for g in noise])
        noisy = md.add_minedojo_exploration_noise(actions, torch.tensor(0.5, device=device), to,
                                                  [(g.to(device), u.to(device)) for g, u in expl])
        out[device] = ([a.cpu() for a in noisy], [d.probs.cpu() for d in dists])
    for a, b in zip(out["cpu"][0], out["cuda"][0]):
        assert torch.equal(a.argmax(-1), b.argmax(-1))
    for a, b in zip(out["cpu"][1], out["cuda"][1]):
        assert torch.isfinite(b).all() and (a - b).abs().max().item() <= 1e-6


def _lockstep(env_name, n=2):
    """The graphed acting step on the card against the CPU player, over ``n`` envs of the port's pipeline."""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import ExplorationStep, build_agent, build_player_fns
    from sheeprl_tpu_torch.algos.dreamer_v3.minedojo_actor import MASK_KEYS
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import normalize_obs, prepare_obs
    from sheeprl_tpu_torch.kernels import ops
    from sheeprl_tpu_torch.utils.env import build_env

    cfg = compose(overrides=ENVS[env_name] + SMALL)
    envs = [build_env(cfg, 5 + i, 0, vector_env_idx=i) for i in range(n)]
    cnn_keys, mlp_keys = list(cfg.cnn_keys.encoder), list(cfg.mlp_keys.encoder)
    space, action_space = envs[0].observation_space, envs[0].action_space
    actions_dim = tuple(int(d) for d in np.atleast_1d(getattr(action_space, "nvec", getattr(action_space, "n", 0))))
    shapes = {k: space[k].shape for k in cnn_keys + mlp_keys}
    world_model, actor = build_agent(cfg, actions_dim, False, shapes, device="cuda", training=False, seed=3)
    cpu_wm, cpu_actor = build_agent(cfg, actions_dim, False, shapes, device="cpu", training=False, seed=3)
    cpu_wm.load_state_dict({k: v.cpu() for k, v in world_model.state_dict().items()})
    cpu_actor.load_state_dict({k: v.cpu() for k, v in actor.state_dict().items()})
    card, host = (build_player_fns(w, a, cfg, actions_dim, False) for w, a in ((world_model, actor), (cpu_wm, cpu_actor)))
    masked = env_name == "minedojo"

    def stacked(raw):
        return {k: np.stack([r[k] for r in raw]) for k in raw[0]}

    raw = stacked([env.reset(seed=5 + i)[0] for i, env in enumerate(envs)])
    obs = prepare_obs(raw, cnn_keys, mlp_keys, n)
    masks = {k: raw[k] for k in MASK_KEYS} if masked else {}
    acting = ExplorationStep(card, n, obs, cnn_keys, None, "cuda", reset_in_step=False, masks_example=masks or None)
    gen = torch.Generator().manual_seed(1)
    ops.hafner_cell_launches.reset()
    ended = 0
    for _ in range(STEPS):
        before = {k: v.detach().cpu().clone() for k, v in acting.state.items()}
        noise = host["draw_exploration_noise"](n, gen)
        card_actions = [a.cpu() for a in acting(obs, None, 0.3, noise=noise, masks=masks)]
        cpu_actions, cpu_state = host["exploration_action"](
            before, normalize_obs(obs, cnn_keys, torch.device("cpu")), 0.3, gumbel=noise["gumbel"],
            action_gumbels=noise["action_gumbels"], expl_noise=noise["expl_noise"],
            masks={k: torch.from_numpy(v) for k, v in masks.items()} if masked else None)
        for a, b in zip(card_actions, cpu_actions):
            assert torch.equal(a.argmax(-1), b.argmax(-1))
        for k in ("recurrent", "stochastic"):
            assert (acting.state[k].cpu() - cpu_state[k]).abs().max().item() <= TOL_STATE
        real = np.stack([a.argmax(-1).numpy() for a in card_actions], -1)
        steps = [env.step(real[i] if masked else real[i, 0]) for i, env in enumerate(envs)]
        done = np.array([s[2] or s[3] for s in steps])
        ended += int(done.sum())
        raw = stacked([env.reset()[0] if d else s[0] for env, s, d in zip(envs, steps, done)])
        obs = prepare_obs(raw, cnn_keys, mlp_keys, n)
        masks = {k: raw[k] for k in MASK_KEYS} if masked else {}
        if done.any():
            acting.reset(done.astype(np.float32).reshape(n, 1))
    assert ops.hafner_cell_launches.count == STEPS  # one cell launch an acting step, the graph's replays included
    assert acting.step.replays == STEPS - 3 and ended == n
    return envs


@pytest.mark.cuda
def test_a_minedojo_wrapper_feeds_the_graphed_masked_player(cuda, stand_ins):
    envs = _lockstep("minedojo")
    stand_ins = [env.unwrapped.env for env in envs]
    assert sum(len(s.received) for s in stand_ins) == 2 * STEPS
    assert [s.invalid for s in stand_ins] == [[], []]  # every action valid under the masks handed out before it


@pytest.mark.cuda
def test_a_minerl_wrapper_feeds_the_graphed_player(cuda, stand_ins):
    envs = _lockstep("minerl")
    assert all(isinstance(a, dict) and "camera" in a for env in envs for a in env.unwrapped.env.received)

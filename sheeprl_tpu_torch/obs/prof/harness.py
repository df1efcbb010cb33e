"""One builder of "a family's real train step on synthetic data"
(counterpart of ``sheeprl_tpu/obs/prof/harness.py``).

Compose the preset, build the agent, its optimizers and the family's real
train program (``build_train_fn`` / the on-policy ``UpdateProgram``, the
same program the training loop runs, each step replayed from a CUDA graph
on the card), and a seeded synthetic batch of the preset's shape.
:func:`build_harness` does it for every family the roofline report
profiles (DV1, DV2, DV3, the P2E exploration steps, SAC, PPO);
:func:`build_trainer` is the Dreamer families' part at any of the bench's
presets (``PRESETS``, the widths ``sheeprl_tpu_torch.tools.bench_dreamer``
and ``chip_smoke.py`` train at). A profiled number therefore always
measures the program the loop runs.

The returned :class:`Harness` runs graphed steps (``run(n)``), counts one
step's FLOPs and bytes on an eager call (``cost()``), and hands back the raw
pieces (``cfg``, ``state``, ``program``, ``data``) for tools that probe
beyond stepping.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "ALGOS",
    "FAMILIES",
    "Harness",
    "PRESETS",
    "build_harness",
    "build_trainer",
    "synthetic_batch",
    "tiny_overrides",
]

ACTIONS = (9,)
OBS = {"rgb": (3, 64, 64)}
WALKER_OBS = {"rgb": (3, 64, 64), "state": (24,)}
#: DIAMBRA's Dead or Alive++ as the preset's keys see it (the DIAMBRA wrapper's spaces: every non-Box key a
#: 1-wide Box) and its 16 combo-discrete actions (9 moves + 8 attack-button combinations - 1 shared no-op);
#: the L preset's legacy key names with an RGB frame, and the P2E L presets' role-relative names with a grey frame
#: and the reward as an observation
DOAPP_L_OBS = {"frame": (3, 64, 64), **{k: (1,) for k in (
    "P1_actions_attack", "P1_actions_move", "P1_oppChar", "P1_oppHealth", "P1_oppSide", "P1_oppWins", "P1_ownChar",
    "P1_ownHealth", "P1_ownSide", "P1_ownWins", "stage")}}
DOAPP_P2E_OBS = {"frame": (1, 64, 64), **{k: (1,) for k in (
    "own_character", "own_health", "own_side", "own_wins", "opp_character", "opp_health", "opp_side", "opp_wins",
    "stage", "timer", "action", "reward")}}
DOAPP_ACTIONS = (16,)
#: Crafter: its frame and the reward as an observation, its 17 actions
CRAFTER_OBS = {"rgb": (3, 64, 64), "reward": (1,)}
CRAFTER_ACTIONS = (17,)
#: the dummy envs' actions: 2 discrete (``discrete_dummy``) or a 2-wide Box (``continuous_dummy``)
DUMMY_ACTIONS = (2,)
#: the agent and training modules of each family
ALGOS = {
    "dreamer_v1": ("sheeprl_tpu_torch.algos.dreamer_v1.agent", "sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1"),
    "p2e_dv1": ("sheeprl_tpu_torch.algos.p2e_dv1.agent", "sheeprl_tpu_torch.algos.p2e_dv1.p2e_dv1_exploration"),
    "dreamer_v2": ("sheeprl_tpu_torch.algos.dreamer_v2.agent", "sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2"),
    "dreamer_v3": ("sheeprl_tpu_torch.algos.dreamer_v3.agent", "sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3"),
    "p2e_dv2": ("sheeprl_tpu_torch.algos.p2e_dv2.agent", "sheeprl_tpu_torch.algos.p2e_dv2.p2e_dv2_exploration"),
    "p2e_dv3": ("sheeprl_tpu_torch.algos.p2e_dv3.agent", "sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_exploration"),
}
#: ``--algo`` → (family, ``exp=``, observation shapes, actions, continuous[, config overrides])
PRESETS = {
    "dreamer_v2": ("dreamer_v2", "dreamer_v2_ms_pacman", OBS, ACTIONS, False),
    "dreamer_v3": ("dreamer_v3", "dreamer_v3_100k_ms_pacman", OBS, ACTIONS, False),
    "dreamer_v3_walker": ("dreamer_v3", "dreamer_v3_dmc_walker_walk", WALKER_OBS, (6,), True),
    "dreamer_v2_continuous": ("dreamer_v2", "dreamer_v2", OBS, (2,), True),
    # Plan2Explore's exploration step at its presets' widths: DV3's default (dense 256, recurrent 256, 32x32
    # latent, B=16 x T=64, an 8-member ensemble, two exploration critics) and DV2's (dense 400 x 4, recurrent
    # 400, B=16 x T=50, 10 members); the DV3 one also on the walker's observations and 6 continuous actions
    "p2e_dv3": ("p2e_dv3", "p2e_dv3_exploration", OBS, ACTIONS, False),
    "p2e_dv3_continuous": ("p2e_dv3", "p2e_dv3_exploration", WALKER_OBS, (6,), True,
                           {"mlp_keys.encoder": ["state"], "mlp_keys.decoder": ["state"]}),
    "p2e_dv2": ("p2e_dv2", "p2e_dv2_exploration", OBS, ACTIONS, False),
    # the L and XL widths in f32 (DIAMBRA's L preset: recurrent 2048, dense 768 x 4, CNN multiplier 64, B=16 x T=64;
    # Crafter's XL: recurrent 4096, dense 1024 x 5, CNN multiplier 96), and P2E-DV3's L DIAMBRA exploration preset
    # under its bf16-mixed (recurrent 1024, dense 768 x 4, CNN multiplier 48, B=4 x T=64)
    "dreamer_v3_L": ("dreamer_v3", "dreamer_v3_L_doapp", DOAPP_L_OBS, DOAPP_ACTIONS, False),
    "dreamer_v3_XL": ("dreamer_v3", "dreamer_v3_XL_crafter", CRAFTER_OBS, CRAFTER_ACTIONS, False),
    "p2e_dv3_L_bf16": ("p2e_dv3", "p2e_dv3_expl_L_doapp_128px_gray_combo_discrete_15Mexpl_20Mstps", DOAPP_P2E_OBS,
                       DOAPP_ACTIONS, False),
    # DreamerV1 at its preset's width (recurrent 200, Gaussian stochastic 30, dense 400 x 4, CNN multiplier 32,
    # B=50 x T=50, horizon 15) on the dummy envs' spaces (2 discrete actions, or a 2-wide Box), and P2E-DV1's
    # exploration step at its own (recurrent 400, stochastic 60, hidden 400, 10 members regressing the 1024-wide
    # embedding)
    "dreamer_v1": ("dreamer_v1", "dreamer_v1", OBS, DUMMY_ACTIONS, False),
    "dreamer_v1_continuous": ("dreamer_v1", "dreamer_v1", OBS, DUMMY_ACTIONS, True),
    "p2e_dv1": ("p2e_dv1", "p2e_dv1_exploration", OBS, DUMMY_ACTIONS, False),
}


def synthetic_batch(T: int, B: int, actions_dim: int, seed: int = 0, continuous: bool = False,
                    obs=None) -> Dict[str, np.ndarray]:
    """A seeded synthetic replay batch on the host, as the JAX
    bench makes it: uint8 frames ``[T, B, 3, 64, 64]`` (and a
    Gaussian float vector for each other key of ``obs``), one-hot actions
    (uniform in [−1, 1] when ``continuous``), Gaussian rewards, no episode
    ends."""
    import numpy as np

    obs = OBS if obs is None else obs
    rng = np.random.default_rng(seed)
    batch = {
        k: rng.integers(0, 256, size=(T, B) + tuple(shape)).astype(np.uint8) if len(shape) == 3
        else rng.normal(size=(T, B) + tuple(shape)).astype(np.float32)
        for k, shape in obs.items()
    }
    if continuous:
        batch["actions"] = rng.uniform(-1.0, 1.0, (T, B, actions_dim)).astype(np.float32)
    else:
        batch["actions"] = np.eye(actions_dim, dtype=np.float32)[rng.integers(0, actions_dim, (T, B))]
    batch.update(
        rewards=rng.normal(size=(T, B, 1)).astype(np.float32),
        dones=np.zeros((T, B, 1), np.float32),
        is_first=np.zeros((T, B, 1), np.float32),
    )
    return batch


#: the last preset's seeded modules as built on the CPU, ``(key, modules)``: the agents initialize every weight
#: on the CPU and then move it, so a copy of this build moved to a device is that device's build (an XL world
#: model's initialization takes seconds a build, and a bench or a check builds the same trainer several times)
_LAST_CPU_BUILD: list = [None, None]


def _moved(node, device):
    """``node`` (a module, or a tuple, list or dict of them) copied onto ``device``."""
    import copy

    import torch

    if isinstance(node, torch.nn.Module):
        return copy.deepcopy(node).to(device)
    if isinstance(node, dict):
        return {k: _moved(v, device) for k, v in node.items()}
    return type(node)(_moved(v, device) for v in node)


def build_trainer(device=None, seed: int = 0, algo: str = "dreamer_v2", **overrides):
    """``(cfg, state, program, data)`` of the preset ``algo`` (PRESETS) at
    its width (with ``overrides``) on ``device``: ``program`` is the
    gradient step's ``TrainProgram``; the state's generator draws the
    noise."""
    import importlib

    import torch

    from sheeprl_tpu_torch import configs
    from sheeprl_tpu_torch.device import resolve_device

    family, exp, obs, actions, continuous, *preset_overrides = PRESETS[algo]
    agent_module, train_module = ALGOS[family]
    agent, train = importlib.import_module(agent_module), importlib.import_module(train_module)
    dev = resolve_device(device)
    cfg = configs.dreamer_v2_config(exp, **{**(preset_overrides[0] if preset_overrides else {}), **overrides})
    key = (algo, seed, repr(sorted(overrides.items())))
    if _LAST_CPU_BUILD[0] != key:
        _LAST_CPU_BUILD[:] = [None, None]  # the previous build's memory goes before this one's is taken
        _LAST_CPU_BUILD[:] = [key, agent.build_agent(cfg, actions, continuous, obs, seed=seed, device="cpu",
                                                     training=True)]
    modules = _moved(_LAST_CPU_BUILD[1], dev)
    state = train.build_optimizers_and_state(cfg, *modules, generator=torch.Generator(device=dev).manual_seed(seed))
    T, B = int(cfg.per_rank_sequence_length), int(cfg.per_rank_batch_size)
    batch = synthetic_batch(T, B, int(sum(actions)), seed=seed, continuous=continuous, obs=obs)
    data = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    return cfg, state, train.build_train_fn(cfg, actions, continuous), data


#: family -> (bench preset or flat family, the JAX family's exp)
FAMILIES: Dict[str, Tuple[str, str]] = {
    "dv1": ("dreamer_v1", "dreamer_v1"),
    "dv2": ("dreamer_v2", "dreamer_v2_ms_pacman"),
    "dv3": ("dreamer_v3", "dreamer_v3_100k_ms_pacman"),
    "p2e_dv1": ("p2e_dv1", "p2e_dv1_exploration"),
    "p2e_dv2": ("p2e_dv2", "p2e_dv2_exploration"),
    "p2e_dv3": ("p2e_dv3", "p2e_dv3_exploration"),
    "sac": ("sac", "sac"),
    "ppo": ("ppo", "ppo"),
}

#: the tiny preset keeps a whole train step CPU-feasible (the JAX harness's shrink)
_DREAMER_TINY = {
    "per_rank_batch_size": 4,
    "per_rank_sequence_length": 8,
    "algo.horizon": 5,
    "algo.dense_units": 32,
    "algo.mlp_layers": 1,
    "algo.world_model.encoder.cnn_channels_multiplier": 4,
    "algo.world_model.recurrent_model.recurrent_state_size": 32,
    "algo.world_model.transition_model.hidden_size": 32,
    "algo.world_model.representation_model.hidden_size": 32,
}
_FAMILY_TINY = {
    "dv1": {"algo.world_model.stochastic_size": 8},
    "dv2": {"algo.world_model.stochastic_size": 8, "algo.world_model.discrete_size": 8},
    "dv3": {"algo.world_model.stochastic_size": 8, "algo.world_model.discrete_size": 8},
    "p2e_dv1": {"algo.world_model.stochastic_size": 8},
    "p2e_dv2": {"algo.world_model.stochastic_size": 8, "algo.world_model.discrete_size": 8},
    "p2e_dv3": {"algo.world_model.stochastic_size": 8, "algo.world_model.discrete_size": 8},
    "sac": {},
    "ppo": {},
}


def tiny_overrides(family: str) -> Dict[str, Any]:
    """Config overrides shrinking ``family``'s model to CPU scale."""
    if family in ("sac", "ppo"):
        return dict(_FAMILY_TINY[family])
    return {**_DREAMER_TINY, **_FAMILY_TINY[family]}


class Harness:
    """A runnable train step: ``run(n)`` makes ``n`` gradient-step calls
    (replayed from the captured graph once warm on the card) and waits for
    the device; ``cost()`` counts one call's FLOPs and bytes on an eager
    call; ``calls_per_run`` is the step calls one ``run(1)`` makes (PPO's
    update: its epochs × minibatches)."""

    def __init__(self, family: str, cfg, device, step_fn: Callable[[], Any], eager_fn: Callable[[], Any],
                 pieces: Dict[str, Any], calls_per_run: int = 1):
        self.family = family
        self.cfg = cfg
        self.device = device
        self._step_fn = step_fn
        self._eager_fn = eager_fn
        self.pieces = pieces
        self.calls_per_run = int(calls_per_run)
        self.dispatches = 0

    def run(self, n: int = 1) -> None:
        import torch

        for _ in range(int(n)):
            self._step_fn()
            self.dispatches += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm_up(self) -> None:
        """Past the capture's eager calls: every later call is a replay."""
        from sheeprl_tpu_torch.train.graphs import WARMUP_CALLS

        self.run(-(-(WARMUP_CALLS + 1) // self.calls_per_run))

    def cost(self) -> Optional[Dict[str, float]]:
        """``{"flops", "bytes_accessed"}`` of one gradient-step call (an eager call), or None."""
        from sheeprl_tpu_torch.obs.prof.roofline import cost_of

        return cost_of(self._eager_fn)


def build_harness(family: str, overrides: Optional[Dict[str, Any]] = None, tiny: bool = False, seed: int = 0,
                  device=None) -> Harness:
    """``family``'s train step (FAMILIES) on synthetic data on ``device``
    (the card unless ``cpu``), at its preset's width or, ``tiny``, at CPU
    scale, with config ``overrides`` (dotted keys)."""
    import torch

    from sheeprl_tpu_torch.device import resolve_device

    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r}; choose from {sorted(FAMILIES)}")
    dev = resolve_device(device)
    ovr = {**(tiny_overrides(family) if tiny else {}), **dict(overrides or {})}
    if family == "sac":
        return _build_sac(ovr, seed, dev)
    if family == "ppo":
        return _build_ppo(ovr, seed, dev)
    preset, _exp = FAMILIES[family]
    cfg, state, program, data = build_trainer(dev, seed, preset, **ovr)
    stack = {k: v[None] for k, v in data.items()}
    return Harness(
        family, cfg, dev, lambda: program.burst(state, stack, [0.0]),
        lambda: program(state, data, tau=0.0), dict(cfg=cfg, state=state, program=program, data=data),
    )


def _compose(exp: str, overrides: Dict[str, Any], extra: Sequence[str] = ()):
    from sheeprl_tpu_torch.config import compose

    return compose(overrides=[f"exp={exp}", "env=dummy", "metric.log_level=0", *extra]
                   + [f"{k}={v}" for k, v in overrides.items()])


def _build_sac(overrides: Dict[str, Any], seed: int, dev) -> Harness:
    """SAC at its preset's width on LunarLanderContinuous's spaces (8-wide
    observations, 2 actions), one gradient step a call."""
    import torch

    from sheeprl_tpu_torch.algos.sac import sac
    from sheeprl_tpu_torch.algos.sac.agent import build_agent_state

    cfg = _compose("sac", overrides)
    obs_dim, act_dim = 8, 2
    agent = build_agent_state(obs_dim, act_dim, int(cfg.algo.actor.hidden_size), int(cfg.algo.critic.hidden_size),
                              int(cfg.algo.critic.n), float(cfg.algo.alpha.alpha), torch.Generator().manual_seed(seed),
                              device=dev)
    state = sac.build_optimizers_and_state(cfg, agent, generator=torch.Generator(device=dev).manual_seed(seed))
    state["action_scale"] = torch.ones(act_dim, device=dev)
    state["action_bias"] = torch.zeros(act_dim, device=dev)
    program = sac.build_train_fn(cfg, act_dim, -float(act_dim))
    rng = np.random.default_rng(seed)
    B = int(cfg.per_rank_batch_size)
    data = {
        "observations": rng.normal(size=(B, obs_dim)).astype(np.float32),
        "next_observations": rng.normal(size=(B, obs_dim)).astype(np.float32),
        "actions": rng.uniform(-1, 1, (B, act_dim)).astype(np.float32),
        "rewards": rng.normal(size=(B, 1)).astype(np.float32),
        "dones": np.zeros((B, 1), np.float32),
    }
    data = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
    stack = {k: v[None] for k, v in data.items()}
    gates = sac.ema_gates(True, float(cfg.algo.tau))
    return Harness("sac", cfg, dev, lambda: program.burst(state, stack, gates),
                   lambda: program(state, data, gates=gates), dict(cfg=cfg, state=state, program=program, data=data))


def _build_ppo(overrides: Dict[str, Any], seed: int, dev) -> Harness:
    """PPO at its preset's width on CartPole's spaces (a 4-wide ``state``, 2
    actions): one ``run`` is one update (epochs × minibatch steps)."""
    from types import SimpleNamespace

    import torch

    from sheeprl_tpu_torch.algos.ppo.agent import build_agent
    from sheeprl_tpu_torch.algos.ppo.ppo import PPO, build_optimizer
    from sheeprl_tpu_torch.envs import spaces

    cfg = _compose("ppo", overrides, ("cnn_keys.encoder=[]", "mlp_keys.encoder=[state]"))
    obs_dim, A = 4, 2
    observation_space = spaces.Dict({"state": spaces.Box(-np.inf, np.inf, (obs_dim,), np.float32)})
    agent = build_agent(cfg, (A,), False, [], ["state"], observation_space, torch.Generator().manual_seed(seed),
                        device=dev)
    n = PPO.samples(cfg)
    run = SimpleNamespace(actions_dim=(A,), is_continuous=False, cnn_keys=[], obs_keys=["state"],
                          generator=torch.Generator(device=dev).manual_seed(seed))
    program = PPO.make_program(cfg, agent, build_optimizer(cfg, agent), run, n, dev)
    rng = np.random.default_rng(seed)
    data = {
        "state": rng.normal(size=(n, obs_dim)).astype(np.float32),
        "actions": np.eye(A, dtype=np.float32)[rng.integers(0, A, n)],
        "logprobs": (np.log(1.0 / A) + 0.1 * rng.normal(size=(n, 1))).astype(np.float32),
        **{k: rng.normal(size=(n, 1)).astype(np.float32) for k in ("values", "returns", "advantages")},
    }
    scalars = [float(cfg.algo.clip_coef), float(cfg.algo.ent_coef)]
    program.load(data)
    program.scalars.copy_(torch.as_tensor(np.asarray(scalars, np.float32)))
    return Harness("ppo", cfg, dev, lambda: program.update(data, scalars), program._step,
                   dict(cfg=cfg, agent=agent, program=program, data=data),
                   calls_per_run=program.epochs * program.n_minibatches)

"""The port's learning-health plane (``sheeprl_tpu_torch/obs/learn``) on the
CPU, held against the JAX package's ``sheeprl_tpu/obs/learn``:

- ``learn_probes`` against JAX's on the same seeded gradients, parameters,
  updates and losses (a non-finite leaf, clipped and unclipped modules):
  per-module norms, the ratio and the parameter norm within rtol 1e-5 (two
  float32 sums of squares in different orders), ``clip_frac`` and
  ``nonfinite`` exact;
- the probes a tapped step collects (raw gradients before the clip, the
  parameters before the step, the optimizer's ‖lr·u‖²) against
  ``learn_probes`` on the same tensors (rtol 1e-6);
- ``LearnSentinel`` against JAX's on one seeded probe stream with a spike
  and non-finite values: the same events in the same order, the same
  flight triggers and counters, an equal ``summary()``;
- ``observe_probes``: one pull a burst at the ``every_n_bursts`` cadence;
- the in-graph probes of a whole train step against the JAX step's, from the
  same weights, batch and noise: DreamerV3 (one step), SAC (one step), PPO
  (an update of 2 epochs × 2 minibatches, every step's sample); norms
  within rtol 2e-4 (the gradients' own parity: float32 sums over
  different orders), the update ratio within rtol 1e-3 (Adam's first
  update ``lr·m/(√v+ε)`` is ``±lr`` where a gradient is far from 0 and
  swings where it is near it), ``clip_frac`` and ``nonfinite`` exact;
- probes off: a DreamerV3 step built without a sentinel is bitwise the step
  built before the plane existed, and a step built with the probes on
  leaves the same parameters and metrics, bit for bit (the probes only
  read).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_jit_build import jit_build

from sheeprl_tpu_torch.obs import learn
from sheeprl_tpu_torch.obs.learn import LearnSentinel, LearnTap, learn_probes, probe_losses, probe_update, tapped
from sheeprl_tpu_torch.utils.optim import Adam, clip_by_global_norm_

NORM_TOL = dict(rtol=1e-5, atol=0)
STEP_NORM_TOL = dict(rtol=2e-4, atol=1e-7)
RATIO_TOL = dict(rtol=1e-3, atol=1e-9)


@pytest.fixture(autouse=True, scope="module")
def restore_prng_impl():
    """The JAX Fabric switches JAX's default key implementation for the
    whole process: put it back after the module."""
    saved = jax.config.jax_default_prng_impl
    yield
    jax.config.update("jax_default_prng_impl", saved)


@pytest.fixture
def sentinels():
    """Both packages' sentinels installed (the build-time gate of the steps), removed after."""
    from sheeprl_tpu.obs import learn as jax_learn

    jax_learn.install(jax_learn.LearnSentinel())
    learn.install(LearnSentinel())
    yield
    jax_learn.install(None)
    learn.install(None)


def _tree(rng, shapes, scale=1.0):
    return {k: (scale * rng.randn(*s)).astype(np.float32) for k, s in shapes.items()}


def _assert_probes(got, want, norm_tol=NORM_TOL, ratio_tol=RATIO_TOL):
    got = {k: float(v) for k, v in got.items()}
    want = {k: float(np.asarray(v).reshape(-1)[-1]) if np.ndim(v) else float(v) for k, v in want.items()}
    assert set(got) == set(want)
    for k, w in want.items():
        if k.endswith(("clip_frac", "nonfinite")):
            assert got[k] == w, k
        elif k.endswith("update_ratio"):
            np.testing.assert_allclose(got[k], w, **ratio_tol, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], w, **norm_tol, err_msg=k)


@pytest.mark.parametrize("nan_in", [None, "actor", "loss"])
def test_learn_probes_match_jax(nan_in):
    from sheeprl_tpu.obs.learn import learn_probes as jax_learn_probes

    rng = np.random.RandomState(3)
    shapes = {"world_model": {"w": (7, 5), "b": (5,)}, "actor": {"w": (5, 3)}, "critic": {"w": (5, 1), "b": (1,)}}
    grads = {m: _tree(rng, s, 4.0) for m, s in shapes.items()}
    params = {m: _tree(rng, s) for m, s in shapes.items()}
    updates = {m: _tree(rng, s, 1e-3) for m, s in shapes.items()}
    losses = (np.float32(1.5), np.float32(-0.25), np.float32(3.0))
    if nan_in == "actor":
        grads["actor"]["w"][1, 2] = np.nan
    elif nan_in == "loss":
        losses = (np.float32(np.inf),) + losses[1:]
    clips = {"world_model": 1.0, "actor": 1e3, "critic": None}
    want = jax_learn_probes({m: {k: jnp.asarray(v) for k, v in t.items()} for m, t in grads.items()},
                            params=params, updates=updates, losses=tuple(jnp.asarray(x) for x in losses),
                            clip_norms=clips)
    t = lambda tree: {m: {k: torch.from_numpy(v.copy()) for k, v in s.items()} for m, s in tree.items()}  # noqa: E731
    got = learn_probes(t(grads), params=t(params), updates=t(updates),
                       losses=tuple(torch.tensor(x) for x in losses), clip_norms=clips)
    assert set(got) == set(want)
    for k, w in want.items():
        w, g = float(w), float(got[k])
        if k.endswith(("clip_frac", "nonfinite")) or not np.isfinite(w):
            assert (g == w) or (np.isnan(g) and np.isnan(w)), (k, g, w)
        else:
            np.testing.assert_allclose(g, w, **NORM_TOL, err_msg=k)
    assert float(got["learn/nonfinite"]) == (0.0 if nan_in is None else 1.0)


def test_a_tapped_step_probes_the_raw_gradients_and_the_applied_update():
    """One step of two modules (one clipped below its norm) in a tapped body:
    the tap's probes equal ``learn_probes`` on the gradients before the
    clip, the parameters before the step and ``p_before − p_after``."""
    torch.manual_seed(0)
    a, b = torch.nn.Linear(6, 4), torch.nn.Linear(4, 2)
    opts = {"a": Adam(a.parameters(), lr=1e-2), "b": Adam(b.parameters(), lr=3e-3, weight_decay=0.1)}
    x = torch.randn(5, 6)
    seen = {}

    def body():
        for m in (a, b):
            for p in m.parameters():
                p.grad = None
        loss = (b(torch.tanh(a(x))) ** 2).sum() * 50.0
        loss.backward()
        for name, module, clip in (("a", a, 0.1), ("b", b, None)):
            params = list(module.parameters())
            grads = [p.grad for p in params]
            seen[name] = ([g.clone() for g in grads], [p.detach().clone() for p in params])
            probed = probe_update(name, grads, params, opts[name], clip)
            if clip:
                clip_by_global_norm_(grads, clip)
            opts[name].step()
            probed()
        probe_losses(loss)
        return loss.detach()

    tap = LearnTap()
    loss = tapped(body, tap)()
    got = tap.last()
    modules = {"a": a, "b": b}
    updates = {n: [p0 - p.detach() for p0, p in zip(seen[n][1], modules[n].parameters())] for n in seen}
    want = learn_probes({n: seen[n][0] for n in seen}, params={n: seen[n][1] for n in seen}, updates=updates,
                        losses=(loss,), clip_norms={"a": 0.1, "b": None})
    _assert_probes(got, want, norm_tol=dict(rtol=1e-6, atol=0), ratio_tol=dict(rtol=1e-6, atol=0))
    assert float(got["learn/clip_frac"]) == 1.0
    assert tapped(body, None) is body


def _probe_stream(n=90, seed=7):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        g = float(np.exp(rng.normal(0.0, 0.1)))
        if 60 <= i < 66:
            g *= 1e5  # a sustained explosion
        probes = {"learn/grad_norm": np.float32(g), "learn/grad_norm/actor": np.float32(g * 0.3),
                  "learn/update_ratio": np.float32(1e-3 * np.exp(rng.normal(0.0, 0.05))),
                  "learn/param_norm": np.float32(10.0 + 0.01 * i), "learn/nonfinite": np.float32(0.0)}
        if i == 40:
            probes["learn/update_ratio"] = np.float32(1e-9)  # a collapse
        if i == 75:
            probes["learn/grad_norm/actor"] = np.float32(np.nan)
        if i == 80:
            probes["learn/nonfinite"] = np.float32(2.0)
        out.append(probes)
    return out


class _Recorder:
    def __init__(self):
        self.calls = []

    def add_learn_event(self, warnings=0, criticals=0):
        self.calls.append(("event", warnings, criticals))

    def trigger(self, reason, detail):
        self.calls.append(("trigger", reason, detail["severity"], detail["probe"], detail["reason"]))


def _strip(events):
    return [{k: v for k, v in e.items() if k != "ts_unix"} for e in events]


def test_the_sentinel_matches_jax():
    from sheeprl_tpu.obs.learn import LearnSentinel as JaxSentinel

    cfg = {"warn_z": 4.0, "critical_z": 8.0, "warmup": 20, "critical_streak": 3, "every_n_bursts": 1}
    sides = []
    for cls in (LearnSentinel, JaxSentinel):
        counters, flight = _Recorder(), _Recorder()
        s = cls(cfg, counters=counters, flight=flight)
        for i, probes in enumerate(_probe_stream()):
            if i % 9 == 0:  # a burst's stacked samples
                s.observe({k: np.stack([v, v]) for k, v in probes.items()}, step=i)
            else:
                s.observe(probes, step=i)
        s.on_nonfinite("Loss/value_loss", float("nan"))
        summary = s.summary()
        sides.append((_strip(summary.pop("events")), summary.pop("first_nonfinite_ts") is not None, summary,
                      counters.calls, flight.calls, s.warnings, s.criticals))
    assert sides[0] == sides[1]
    events = sides[0][0]
    reasons = {e["reason"] for e in events}
    assert {"sustained_explosion", "grad_norm_excursion", "update_ratio_collapse", "nonfinite_probe",
            "nonfinite_grads", "nonfinite_metric"} <= reasons
    first_critical = next(e for e in events if e["severity"] == "critical")
    assert first_critical["reason"] == "sustained_explosion" and first_critical["step"] < 75


def test_observe_probes_pulls_once_a_due_burst(monkeypatch):
    from sheeprl_tpu_torch.obs import counters as _counters

    counters = _counters.Counters()
    _counters.install(counters)
    sentinel = LearnSentinel({"every_n_bursts": 2})
    learn.install(sentinel)
    try:
        for _ in range(5):
            learn.observe_probes({"learn/grad_norm": torch.tensor([1.0, 2.0, 3.0]),
                                  "learn/nonfinite": torch.zeros(3)})
        learn.observe_probes(None)
    finally:
        learn.install(None)
        _counters.install(None)
    assert counters.learn_probe_fetches == 3 and sentinel.summary()["bursts_observed"] == 5
    assert sentinel.summary()["probes"]["learn/grad_norm"]["n"] == 9
    learn.observe_probes({"learn/grad_norm": torch.ones(1)})  # no sentinel: a no-op


# -- whole steps against the JAX steps ------------------------------------------


def test_dv3_step_probes_match_jax(sentinels):
    import gymnasium as gym
    from test_torch_dreamer_v3_train import ACTIONS, SMALL, _batch, _jax_noise, _torch_side

    from sheeprl_tpu.algos.dreamer_v3 import agent as jax_agent
    from sheeprl_tpu.algos.dreamer_v3 import dreamer_v3 as jax_dv3
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.fabric import Fabric
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import build_train_fn

    # the JAX step of test_torch_dreamer_v3_train's jax_side, built with the JAX sentinel installed
    fabric = Fabric(devices=1, accelerator="cpu")
    jcfg = jax_compose(overrides=["exp=dreamer_v3_100k_ms_pacman", "env=dummy", "metric.log_level=0"]
                       + [f"{k}={v}" for k, v in SMALL.items()])
    space = gym.spaces.Dict({"rgb": gym.spaces.Box(0, 255, (3, 64, 64), np.uint8)})
    wm, actor, critic, params = jit_build(jax_agent.build_agent, jcfg, ACTIONS, False, space, jax.random.PRNGKey(3))
    rng = np.random.RandomState(8)
    for tree in (params["world_model"]["reward_model"], params["critic"]):
        tree["head"]["kernel"] = jnp.asarray(0.3 * rng.randn(*tree["head"]["kernel"].shape).astype(np.float32))
    params["target_critic"] = jax.tree_util.tree_map(lambda p: 0.5 * p, params["critic"])
    txs = jax_dv3.build_optimizers_and_state(jcfg, params)
    train_fn = jax_dv3.build_train_fn(wm, actor, critic, *txs[:3], jcfg, fabric, ACTIONS, False)
    key = jax.random.PRNGKey(11)
    batch = _batch()
    _state, j_metrics = train_fn(jax.tree_util.tree_map(jnp.array, jax.device_get(txs[3])),
                                 {k: jnp.asarray(v) for k, v in batch.items()}, key, jnp.float32(0.02))
    want = {k: v for k, v in jax.device_get(j_metrics).items() if k.startswith("learn/")}
    assert want, "the JAX step was built without probes"

    cfg, torch_state = _torch_side(jax.device_get(params))
    program = build_train_fn(cfg, ACTIONS, False)
    program(torch_state, {k: torch.from_numpy(v) for k, v in batch.items()}, _jax_noise(key), tau=0.02)
    _assert_probes(program.learn_tap.last(), want, norm_tol=STEP_NORM_TOL)


def test_sac_step_probes_match_jax(sentinels):
    from sheeprl_tpu.algos.sac import agent as jax_agent
    from sheeprl_tpu.algos.sac import sac as jax_sac
    from sheeprl_tpu.config.engine import compose as jax_compose
    from sheeprl_tpu.config.instantiate import instantiate as jax_instantiate
    from test_torch_sac import ACT, HIDDEN, HIGH, LOW, SMALL, jax_fabric, jax_state, sac_noise, torch_state, transition_batch

    from sheeprl_tpu_torch.algos.sac import sac
    from sheeprl_tpu_torch.algos.sac.agent import action_bounds
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs import spaces

    jax_fabric()
    _a, _c, params = jax_state()
    batch, key = transition_batch(7), jax.random.PRNGKey(11)
    jcfg = jax_compose(overrides=["exp=sac"] + SMALL)
    actor = jax_agent.SACActor(action_dim=ACT, hidden_size=HIDDEN)
    critic = jax_agent.SACCritic(hidden_size=HIDDEN, num_critics=1)
    txs = {k: jax_instantiate(jcfg.algo[n].optimizer) for k, n in (("actor", "actor"), ("qf", "critic"),
                                                                   ("alpha", "alpha"))}
    opts = {"actor": txs["actor"].init(params["actor"]), "qf": txs["qf"].init(params["critics"]),
            "alpha": txs["alpha"].init(params["log_alpha"])}
    scale, bias = action_bounds(spaces.Box(LOW, HIGH))
    train = jax_sac.build_train_fn(actor, critic, txs["actor"], txs["qf"], txs["alpha"], jcfg, jax_fabric(), scale,
                                   bias, -float(ACT), donate=False)
    outs = train(jax.tree_util.tree_map(jnp.asarray, params), opts, {k: jnp.asarray(v) for k, v in batch.items()},
                 key, jnp.bool_(True))
    assert len(outs) == 4, "the JAX step was built without probes"
    want = jax.device_get(outs[3])

    cfg = compose(overrides=["exp=sac"] + SMALL)
    state = torch_state(cfg, params)
    program = sac.build_train_fn(cfg, ACT, -float(ACT))
    program(state, {k: torch.from_numpy(v[0]) for k, v in batch.items()}, sac_noise(key, 1)[0],
            sac.ema_gates(True, float(cfg.algo.tau)))
    _assert_probes(program.learn_tap.last(), want, norm_tol=STEP_NORM_TOL)


def test_ppo_update_probes_match_jax(sentinels, monkeypatch):
    from test_torch_ppo import ACTIONS, EPOCHS, N_LOCAL, BS, OBS_KINDS, agents, jax_update, rollout_batch, update_overrides

    from sheeprl_tpu.algos.ppo import ppo as jax_ppo
    from sheeprl_tpu_torch.algos.ppo.ppo import UpdateProgram, build_optimizer, ppo_loss, select_rows
    from sheeprl_tpu_torch.config import compose

    kind, action = "mlp", "discrete"
    extra = ("algo.max_grad_norm=0.5",)
    j, params, port = agents(kind, action, key=2)
    overrides = update_overrides(kind, extra)
    data = rollout_batch(5, kind, action)
    captured = {}

    def builder(*a, **k):
        update = jax_ppo.build_update_fn(*a, **k)

        def run(*args):
            outs = update(*args)
            captured["probes"] = jax.device_get(outs[3]) if len(outs) > 3 else None
            return outs

        return run

    _p, _o, _m, perms = jax_update("ppo", overrides, j, params, data, key=9, update_fn_builder=builder)
    want = captured["probes"]
    assert want is not None, "the JAX update was built without probes"

    cfg = compose(overrides=["exp=ppo"] + overrides)
    actions_dim, is_continuous = ACTIONS[action]
    cnn, mlp = OBS_KINDS[kind]
    program = UpdateProgram(ppo_loss(cfg, list(cnn), list(mlp) + list(cnn), actions_dim, is_continuous), select_rows,
                            port, build_optimizer(cfg, port), max_grad_norm=float(cfg.algo.max_grad_norm or 0.0),
                            epochs=EPOCHS, n_samples=N_LOCAL, batch_size=BS, n_metrics=3, n_scalars=2, generator=None,
                            device="cpu")
    flushed = []
    monkeypatch.setattr(learn, "observe_probes", lambda probes, step=None: flushed.append(probes))
    program.update(data, [0.2, 0.01], perms=perms)
    (got,) = flushed
    steps = EPOCHS * (N_LOCAL // BS)
    assert set(got) == set(want)
    for k, w in want.items():
        g, w = got[k].numpy(), np.asarray(w).reshape(-1)
        assert g.shape == w.shape == (steps,), k
        if k.endswith(("clip_frac", "nonfinite")):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, **(RATIO_TOL if k.endswith("update_ratio") else STEP_NORM_TOL),
                                       err_msg=k)


# -- probes off ------------------------------------------------------------------


def _dv3_two_steps(with_sentinel: bool):
    from test_torch_dreamer_v3_train import SMALL, _batch

    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import build_optimizers_and_state, build_train_fn
    from sheeprl_tpu_torch.configs import dreamer_v3_config

    learn.install(LearnSentinel() if with_sentinel else None)
    try:
        cfg = dreamer_v3_config(**SMALL)
        modules = build_agent(cfg, (9,), False, {"rgb": (3, 64, 64)}, seed=4, device="cpu", training=True)
        state = build_optimizers_and_state(cfg, *modules, generator=torch.Generator().manual_seed(5))
        program = build_train_fn(cfg, (9,), False)
    finally:
        learn.install(None)
    metrics = [program(state, {k: torch.from_numpy(v) for k, v in _batch(s).items()}, tau=t)
               for s, t in ((1, 1.0), (2, 0.02))]
    params = {f"{m}.{n}": p.detach().clone() for m in ("world_model", "actor", "critic", "target_critic")
              for n, p in state[m].named_parameters()}
    return program, metrics, params


def test_probes_off_build_no_probe_and_probes_on_change_nothing():
    off, off_metrics, off_params = _dv3_two_steps(False)
    on, on_metrics, on_params = _dv3_two_steps(True)
    assert off.learn_tap is None and on.learn_tap is not None and on.learn_tap.last()
    for a, b in zip(off_metrics, on_metrics):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert off_params.keys() == on_params.keys()
    for k in off_params:
        assert torch.equal(off_params[k], on_params[k]), k

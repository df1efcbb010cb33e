"""The port's train bursts, graph-safe gradient step and acting step on the
CPU (``sheeprl_tpu_torch/train/``), against the JAX package and against the
eager step the port ran before them.

- ``metric_fetch_gate`` and ``tau_schedule`` equal the JAX functions over a
  grid of their arguments;
- the port's ``Adam`` equals optax's ``adam``/``adamw`` over six steps
  within 3e-7 relative (two float32 ulps: XLA fuses the update into one
  loop over the elements and the global norm sums in another order; most
  elements are equal to the bit);
- the graph-safe step body, run eagerly, against the step of the port's
  previous release (a copy below: the target update as a host branch on
  ``tau``, gradients set to None and refilled, ``torch.optim.AdamW``).
  With the optimizer held the same, every loss and parameter after 3 steps
  is equal to the bit. With the previous release's ``torch.optim.AdamW``,
  one step is within 1e-5 relative to each tensor's largest magnitude (read:
  6.8e-6, on the zero-initialised biases, whose whole value is that first
  update). The cause: the port's ``Adam`` follows optax, which forms the
  bias correction ``1 − β₂ⁿ`` in float32 with β₂ = 0.999 rounded to float32
  (``1 − 0.999f`` is 1.3e-5 below 0.001, so ``sqrt`` of it 6.4e-6), where
  ``torch.optim.AdamW`` forms it in float64 on the host; its other
  differences (``p·(1 − lr·wd)`` before the step, ``lerp`` moments) are
  float32 ulps. Over 3 steps the world model's gradient amplifies the
  difference to about 1e-5, so the longer run is held with the same
  optimizer;
- the burst (static buffers, the body the card captures, run eagerly on the
  CPU) equals the eager step bit for bit, and stays within the JAX train
  step's existing limits at injected noise;
- launch counts recorded at a capture are added back on each replay;
- the acting step over static buffers (``ExplorationStep``) equals the
  eager ``exploration_action`` with ``reset_states`` over 16 steps.
"""

import copy
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sheeprl_tpu.train.burst import metric_fetch_gate as jax_metric_fetch_gate
from sheeprl_tpu.train.burst import tau_schedule as jax_tau_schedule
from sheeprl_tpu.utils.optim import Adam as JaxAdam
from sheeprl_tpu_torch.algos.dreamer_v2.agent import ExplorationStep, build_agent, build_player_fns
from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import (
    build_losses,
    build_optimizers_and_state,
    build_train_fn,
    draw_noise,
)
from sheeprl_tpu_torch.algos.dreamer_v2.utils import normalize_obs
from sheeprl_tpu_torch.configs import dreamer_v2_config
from sheeprl_tpu_torch.convert import convert_dreamer_v2
from sheeprl_tpu_torch.kernels import ops
from sheeprl_tpu_torch.train.burst import metric_fetch_gate, run_train_burst, tau_schedule
from sheeprl_tpu_torch.train.graphs import WARMUP_CALLS, CapturedStep
from sheeprl_tpu_torch.utils import dotdict
from sheeprl_tpu_torch.utils.optim import Adam, clip_by_global_norm_
from test_torch_dreamer_v2_train import (  # noqa: F401  (jax_side is a fixture)
    ACTIONS,
    GRAD_TOL,
    METRIC_TOL,
    PARAM_ATOL,
    SMALL,
    _batch,
    _first_moments,
    _jax_noise,
    _torch_side,
    jax_side,
)

STEPS = 3
# one step against torch.optim.AdamW, relative to each tensor's largest magnitude: optax's float32 bias
# correction (the port's) against torch's float64 one (see the module docstring)
ADAMW_REL_TOL = 1e-5


class _Agg:
    def __init__(self, disabled=False):
        self.disabled = disabled


def test_metric_fetch_gate_equals_jax():
    checked = 0
    for train_every, log_every, fetch_every, per_update, log_level in itertools.product(
        (1, 4, 5, 16), (1, 8, 16, 100), (0, 1, 3), (1, 2, 4), (0, 1)
    ):
        cfg = dotdict({"algo": {"train_every": train_every},
                       "metric": {"log_level": log_level, "log_every": log_every, "fetch_train_metrics_every": fetch_every}})
        for agg in (None, _Agg(True), _Agg(False)):
            for policy_step, last_log, train_step, update in itertools.product((0, 8, 96), (0, 8, 90), (0, 3, 6), (2, 30, 49)):
                kwargs = dict(policy_step=policy_step, last_log=last_log, train_step=train_step, update=update,
                              num_updates=50, policy_steps_per_update=per_update, world_size=1)
                assert metric_fetch_gate(cfg, agg, **kwargs) == jax_metric_fetch_gate(cfg, agg, **kwargs), (cfg, kwargs)
                checked += 1
    assert checked > 10000


def test_tau_schedule_equals_jax():
    for n, start, every in itertools.product((1, 3, 16), (0, 1, 99, 100), (1, 7, 100)):
        # DreamerV2's call: hard copies on the cadence
        np.testing.assert_array_equal(
            tau_schedule(n, start, every, tau=1.0, first_hard=False),
            jax_tau_schedule(n, start, every, tau=1.0, first_hard=False),
        )
        np.testing.assert_array_equal(tau_schedule(n, start, every, tau=0.02), jax_tau_schedule(n, start, every, tau=0.02))
    assert tau_schedule(3, 0, 100, tau=1.0, first_hard=False).tolist() == [1.0, 0.0, 0.0]


@pytest.mark.parametrize("weight_decay", [0.0, 1e-6, 0.1])
def test_adam_equals_optax(weight_decay):
    rng = np.random.RandomState(0)
    shapes = [(7, 5), (3,), (2, 3, 4)]
    init = [rng.randn(*s).astype(np.float32) for s in shapes]
    tx = JaxAdam(lr=2e-4, betas=(0.9, 0.999), eps=1e-5, weight_decay=weight_decay, max_grad_norm=100.0)
    jparams = [jnp.asarray(p) for p in init]
    jstate = tx.init(jparams)
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in init]
    opt = Adam(params, lr=2e-4, betas=(0.9, 0.999), eps=1e-5, weight_decay=weight_decay)
    for step in range(6):
        grads = [(rng.randn(*s) * (300.0 if step == 2 else 1.0)).astype(np.float32) for s in shapes]
        updates, jstate = tx.update([jnp.asarray(g) for g in grads], jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g.copy())
        clip_by_global_norm_([p.grad for p in params], 100.0)
        opt.step()
        for p, jp in zip(params, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=3e-7, atol=1e-9)
    assert [float(s["step"]) for s in opt.state.values()] == [6.0] * 3


def test_adam_state_dict_keeps_the_torch_layout_and_loads_in_place():
    p = torch.nn.Parameter(torch.ones(4))
    torch_opt = torch.optim.AdamW([p], lr=1e-3, weight_decay=1e-6)
    p.grad = torch.full((4,), 0.5)
    torch_opt.step()
    saved = {int(i): {k: np.asarray(v) for k, v in s.items()} for i, s in torch_opt.state_dict()["state"].items()}
    q = torch.nn.Parameter(torch.ones(4))
    opt = Adam([q], lr=1e-3, weight_decay=1e-6)
    buffers = {k: v.data_ptr() for k, v in opt.state[q].items()}
    opt.load_state_dict({"state": saved})
    assert {k: v.data_ptr() for k, v in opt.state[q].items()} == buffers
    assert opt.state_dict()["state"][0].keys() == {"step", "exp_avg", "exp_avg_sq"}
    for k in ("step", "exp_avg", "exp_avg_sq"):
        np.testing.assert_array_equal(opt.state[q][k].numpy(), saved[0][k])


def _pr5_train_step(cfg, losses):
    """The gradient step of the port's previous release: the same losses,
    the target chosen by a host branch on ``tau``, gradients set to None and
    refilled by backward, ``torch.optim.AdamW``."""
    from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import _no_param_grads

    def step(module, optimizer, clip):
        params = list(module.parameters())
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        norm = clip_by_global_norm_([p.grad for p in params], clip)
        optimizer.step()
        return norm

    def train_step(state, data, noise, tau):
        wm, actor, critic, target = state["world_model"], state["actor"], state["critic"], state["target_critic"]
        opt = state["opt"]
        with torch.no_grad():
            if tau:
                for t_p, c_p in zip(target.parameters(), critic.parameters()):
                    t_p.copy_(tau * c_p + (1.0 - tau) * t_p)
        for o in opt.values():
            o.zero_grad(set_to_none=True)
        wm_loss, metrics, posteriors, recurrents = losses.world_model_loss(wm, data, noise["posterior"])
        wm_loss.backward()
        norms = {"world_model": step(wm, opt["world_model"], losses.clips["world_model"])}
        true_continue = (1.0 - data["dones"]).reshape(-1, 1)
        with _no_param_grads(wm, target):
            policy_loss, aux = losses.actor_loss(wm, actor, target, posteriors, recurrents, true_continue, noise)
            policy_loss.backward()
        norms["actor"] = step(actor, opt["actor"], losses.clips["actor"])
        value_loss = losses.critic_loss(critic, aux["trajectories"], aux["lambda_values"], aux["discount"])
        value_loss.backward()
        norms["critic"] = step(critic, opt["critic"], losses.clips["critic"])
        metrics = dict(metrics, **{"Loss/policy_loss": policy_loss.detach(), "Loss/value_loss": value_loss.detach()})
        metrics.update({f"Grads/{k}": v for k, v in norms.items()})
        return metrics

    return train_step


def _states(seed=3):
    cfg = dreamer_v2_config(**SMALL)
    modules = build_agent(cfg, ACTIONS, False, {"rgb": (3, 64, 64)}, seed=seed, device="cpu", training=True)
    with torch.no_grad():  # a target that differs from the critic, so that tau matters
        for p in modules[3].parameters():
            p.mul_(0.5)
    state = build_optimizers_and_state(cfg, *modules)
    return cfg, state


def _inputs(cfg, n):
    gen = torch.Generator().manual_seed(7)
    T, B = int(cfg.per_rank_sequence_length), int(cfg.per_rank_batch_size)
    batches = []
    for i in range(n):
        b = _batch()
        b["rgb"] = np.roll(b["rgb"], i, axis=1)
        batches.append({k: torch.from_numpy(v) for k, v in b.items()})
    noise = [draw_noise(cfg, ACTIONS, T, B, gen, "cpu") for _ in range(n)]
    return batches, noise


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _previous(cfg, state, optimizer):
    old = copy.deepcopy({k: state[k] for k in ("world_model", "actor", "critic", "target_critic")})
    if optimizer == "torch_adamw":  # the previous release's optimizer
        old["opt"] = {
            name: torch.optim.AdamW(old[name].parameters(), lr=float(cfg.algo[name].optimizer.lr),
                                    betas=tuple(cfg.algo[name].optimizer.betas),
                                    eps=float(cfg.algo[name].optimizer.eps),
                                    weight_decay=float(cfg.algo[name].optimizer.weight_decay))
            for name in ("world_model", "actor", "critic")
        }
    else:
        old["opt"] = build_optimizers_and_state(cfg, old["world_model"], old["actor"], old["critic"],
                                                old["target_critic"])["opt"]
    return old


@pytest.mark.parametrize("optimizer,steps,tol", [("port_adam", STEPS, 0.0), ("torch_adamw", 1, ADAMW_REL_TOL)])
def test_graph_safe_body_equals_the_previous_eager_step(optimizer, steps, tol):
    cfg, state = _states()
    old = _previous(cfg, state, optimizer)
    program = build_train_fn(cfg, ACTIONS, False)
    previous = _pr5_train_step(cfg, build_losses(cfg, ACTIONS, False))
    batches, noise = _inputs(cfg, steps)
    taus = tau_schedule(steps, 0, 2, tau=1.0, first_hard=False)  # 1, 0, 1
    worst = 0.0
    for data, nz, tau in zip(batches, noise, taus):
        got = program(state, data, nz, float(tau))
        want = previous(old, data, nz, float(tau))
        for k, v in want.items():
            worst = max(worst, _rel(got[k].detach(), v.detach()))
    for name in ("world_model", "actor", "critic", "target_critic"):
        for p, q in zip(state[name].parameters(), old[name].parameters()):
            worst = max(worst, _rel(p.detach(), q.detach()))
    assert worst <= tol, worst


def test_burst_equals_the_eager_step_bit_for_bit():
    cfg, state = _states()
    twin = copy.deepcopy(state)
    twin["opt"] = build_optimizers_and_state(cfg, twin["world_model"], twin["actor"], twin["critic"],
                                             twin["target_critic"])["opt"]
    program = build_train_fn(cfg, ACTIONS, False)
    batches, noise = _inputs(cfg, STEPS)
    stack = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    taus = tau_schedule(STEPS, 0, 2, tau=1.0, first_hard=False)
    fused = run_train_burst(program, state, stack, taus, noise=noise)
    eager = run_train_burst(program, twin, stack, taus, noise=noise, fused=False)
    assert fused == eager
    assert program.static.step.eager_calls == STEPS and program.static.step.graph is None  # the CPU never graphs
    for name in ("world_model", "actor", "critic", "target_critic"):
        for p, q in zip(state[name].parameters(), twin[name].parameters()):
            torch.testing.assert_close(p, q, rtol=0, atol=0)
    assert run_train_burst(program, state, stack, taus[:1], noise=noise[:1], fetch_metrics=False) is None


def test_a_program_bursts_on_one_state_at_one_shape():
    cfg, state = _states()
    program = build_train_fn(cfg, ACTIONS, False)
    assert program.static is None
    batches, noise = _inputs(cfg, 2)
    stack = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    run_train_burst(program, state, stack, [0.0, 0.0], noise=noise)
    static = program.static
    run_train_burst(program, state, {k: v[:1] for k, v in stack.items()}, [0.0], noise=noise[:1])
    assert program.static is static and static.step.eager_calls == 3
    with pytest.raises(ValueError, match="one agent state"):
        program.burst(copy.deepcopy(state), stack, [0.0, 0.0], noise)
    with pytest.raises(ValueError, match="one agent state"):
        program.burst(state, {k: v[:, :-1] for k, v in stack.items()}, [0.0, 0.0], noise)


@pytest.mark.parametrize("tau", [0.0, 1.0])
def test_burst_stays_within_the_jax_train_step_limits(jax_side, tau):
    key = jax.random.PRNGKey(11)
    batch = _batch()
    state0 = jax.tree_util.tree_map(jnp.array, jax_side["state"])
    new_state, j_metrics = jax_side["train_fn"](state0, {k: jnp.asarray(v) for k, v in batch.items()}, key,
                                                jnp.float32(tau))
    j_metrics, new_state = jax.device_get(j_metrics), jax.device_get(new_state)
    cfg, state = _torch_side(jax_side["params"])
    program = build_train_fn(cfg, ACTIONS, False)
    stack = {k: torch.from_numpy(v)[None] for k, v in batch.items()}
    metrics = run_train_burst(program, state, stack, [tau], noise=[_jax_noise(key)])
    for name, value in metrics.items():
        np.testing.assert_allclose(value, float(j_metrics[name]), **METRIC_TOL, err_msg=name)
    after, _ = convert_dreamer_v2(new_state["params"], training=True)
    for name in ("world_model", "actor", "critic"):
        moments, _ = convert_dreamer_v2(
            {**new_state["params"], name: _first_moments(new_state["opt"][name])}, training=True
        )
        for pname, p in state[name].named_parameters():
            np.testing.assert_allclose(state["opt"][name].state[p]["exp_avg"].numpy() / 0.1,
                                       moments[name][pname].numpy() / 0.1, **GRAD_TOL, err_msg=pname)
    for name in ("world_model", "actor", "critic", "target_critic"):
        for pname, value in state[name].state_dict().items():
            np.testing.assert_allclose(value.numpy(), after[name][pname].numpy(), rtol=0, atol=PARAM_ATOL,
                                       err_msg=f"{name}.{pname}")


def test_recorded_launches_are_added_back_on_every_replay():
    cell, seq = ops.hafner_cell_launches, ops.hafner_sequence_launches
    cell.reset()
    seq.reset()
    cell.add()
    with ops.launches_recorded() as recorded:  # as a capture: counted, then taken back
        for _ in range(65):
            cell.add()
        seq.add("persistent")
    assert (cell.count, seq.count, seq.by_variant) == (1, 0, {})
    assert recorded == {"hafner_cell": (65, {}), "hafner_sequence": (1, {"persistent": 1})}
    for _ in range(3):
        ops.add_recorded_launches(recorded)
    assert (cell.count, seq.count, seq.by_variant) == (1 + 195, 3, {"persistent": 3})
    cell.reset()
    seq.reset()


def test_captured_step_runs_eagerly_on_the_cpu():
    calls = []
    step = CapturedStep(lambda: calls.append(1) or len(calls), "cpu")
    assert [step() for _ in range(WARMUP_CALLS + 2)] == list(range(1, WARMUP_CALLS + 3))
    assert (step.eager_calls, step.replays, step.graph, step.warmup_s) == (WARMUP_CALLS + 2, 0, None, 0.0)


def test_acting_step_equals_the_eager_exploration_action():
    cfg = dreamer_v2_config(**SMALL)
    wm, actor = build_agent(cfg, (3, 2), False, {"rgb": (3, 64, 64)}, seed=4, device="cpu")
    fns = build_player_fns(wm, actor, cfg, (3, 2), False)
    n = 4
    rng = np.random.RandomState(5)
    frames = [{"rgb": rng.randint(0, 256, (n, 3, 64, 64)).astype(np.uint8)} for _ in range(16)]
    masks = [(rng.uniform(size=(n, 1)) < 0.25).astype(np.float32) for _ in range(16)]
    gen = torch.Generator().manual_seed(8)
    noises = [fns["draw_exploration_noise"](n, gen) for _ in range(16)]
    acting = ExplorationStep(fns, n, frames[0], ["rgb"], None, "cpu")
    state = fns["init_states"](n)
    for obs, mask, noise, amount in zip(frames, masks, noises, np.linspace(0.0, 1.0, 16)):
        got = acting(obs, mask, float(amount), noise=noise)
        state = fns["reset_states"](state, torch.from_numpy(mask))
        want, state = fns["exploration_action"](
            state, normalize_obs(obs, ["rgb"], torch.device("cpu")), float(amount),
            gumbel=noise["gumbel"], action_gumbels=noise["action_gumbels"], expl_noise=noise["expl_noise"],
        )
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        for k in state:
            torch.testing.assert_close(acting.state[k], state[k], rtol=0, atol=0)
    assert acting.step.eager_calls == 16
    # the exploration draw happens at every amount, so a generator-drawn step advances the stream alike
    a = fns["exploration_action"](fns["init_states"](n), normalize_obs(frames[0], ["rgb"], torch.device("cpu")), 0.0,
                                  torch.Generator().manual_seed(1))
    b = ExplorationStep(fns, n, frames[0], ["rgb"], torch.Generator().manual_seed(1), "cpu")(
        frames[0], np.zeros((n, 1), np.float32), 0.0)
    for x, y in zip(a[0], b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_the_trainer_bench_times_eager_and_graphed_on_the_cpu():
    from sheeprl_tpu_torch.tools import bench_dreamer

    line = bench_dreamer.compare(steps=1, device="cpu", **SMALL)
    assert line["eager"]["mode"] == "eager" and line["graphed"]["mode"] == "graphed"
    # on the CPU the burst runs its body eagerly: the capture's warm-up calls and the timed step
    assert line["graphed"]["graph"] == {"eager_calls": 5, "replays": 0, "warmup_s": 0.0, "capture_s": 0.0}
    for mode in ("eager", "graphed"):
        assert all(np.isfinite(v) for v in line[mode]["losses"].values())


@pytest.mark.parametrize("collecting", [True, False])
def test_capture_guard_collects_first_and_keeps_the_collector_off(collecting):
    """Inside ``capture_guard`` the garbage of before is gone and the
    collector is off; after it the collector is as it was."""
    import gc
    import weakref

    from sheeprl_tpu_torch.train.graphs import capture_guard

    class Held:
        pass

    prev = gc.isenabled()
    try:
        (gc.enable if collecting else gc.disable)()
        cycle = Held()
        cycle.self = cycle
        ref = weakref.ref(cycle)
        del cycle
        with capture_guard():
            assert ref() is None and not gc.isenabled()
        assert gc.isenabled() == collecting
    finally:
        (gc.enable if prev else gc.disable)()

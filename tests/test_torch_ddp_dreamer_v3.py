"""The port's DreamerV3 step on two data-parallel ranks against the JAX
package's step on two devices, on the CPU.

The JAX step runs on a two-device ``Fabric`` (two of the conftest's
virtual devices): its batch ``[T, 2·B, ...]`` is split over the ``data``
axis, each device draws its noise from ``fold_in(key, device index)``,
the gradients and the metrics are ``pmean``'d and ``Moments`` takes its
percentiles over the λ-returns gathered from both. The port's two gloo
ranks (spawned, ``tests/ddp_ranks.py``) each get their half of the batch
and the noise JAX's key schedule gives their device (re-derived here, as
``tests/test_torch_dreamer_v3_train.py`` does for one device), from the
same converted weights. Two eager steps (the first hard-copies the target
critic, the second moves it by τ = 0.02), then the same two as one burst.

Tolerances are ``tests/test_torch_dreamer_v3_train.py``'s: losses and
metrics rtol 1e-4 and atol 1e-6, gradients (the optimizers' first moments)
rtol 1e-3 and atol 2e-5 of each gradient's largest magnitude, parameters
atol 1.6e-6 after one step and 4e-6 after two, the ``Moments`` state rtol
1e-4 and atol 1e-6. The two ranks' parameters, optimizer state, ``Moments``
and metrics are bitwise equal after every step and after the burst.
"""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax_jit_build import jit_build
from test_torch_dreamer_v3_train import (
    ACTIONS,
    BURST_PARAM_ATOL,
    GRAD_ATOL_OF_MAX,
    GRAD_RTOL,
    HORIZON,
    METRIC_TOL,
    PARAM_ATOL,
    SMALL,
    D,
    S,
    T,
    _first_moments,
)

import cpu_threads  # noqa: F401  (one CPU thread a process)
import ddp_ranks
from sheeprl_tpu.algos.dreamer_v3 import agent as jax_agent
from sheeprl_tpu.algos.dreamer_v3 import dreamer_v3 as jax_dv3
from sheeprl_tpu.config import compose
from sheeprl_tpu.fabric import Fabric
from sheeprl_tpu_torch.convert import convert_dreamer_v3
from sheeprl_tpu_torch.parallel import spawn

RANKS, B_RANK = 2, 3
MODULES = ddp_ranks.MODULES


@pytest.fixture(autouse=True, scope="module")
def restore_prng_impl():
    saved = jax.config.jax_default_prng_impl
    yield
    jax.config.update("jax_default_prng_impl", saved)


def global_batch(seed):
    """``[T, 2·B, ...]``: an episode boundary in each rank's half."""
    rng = np.random.RandomState(seed)
    n = RANKS * B_RANK
    dones = np.zeros((T, n, 1), np.float32)
    is_first = np.zeros((T, n, 1), np.float32)
    for r in range(RANKS):
        dones[1, r * B_RANK + 2] = 1.0
        is_first[2, r * B_RANK + 2] = 1.0
    return {
        "rgb": rng.randint(0, 256, (T, n, 3, 64, 64)).astype(np.uint8),
        "actions": np.eye(ACTIONS[0], dtype=np.float32)[rng.randint(0, ACTIONS[0], (T, n))],
        "rewards": (3.0 * rng.randn(T, n, 1)).astype(np.float32),
        "dones": dones,
        "is_first": is_first,
    }


def halves(batch):
    return [{k: np.ascontiguousarray(v[:, r * B_RANK:(r + 1) * B_RANK]) for k, v in batch.items()}
            for r in range(RANKS)]


def rank_noise(key, rank):
    """Device ``rank``'s noise in the JAX step: its key is
    ``fold_in(key, rank)``, the rest of the schedule is one device's."""
    key = jax.random.fold_in(key, rank)
    k_wm, k_img = jax.random.split(key)
    posterior = jax.random.gumbel(k_wm, (T, B_RANK, S, D))
    k0, key = jax.random.split(k_img)
    k_gum, key = jax.random.split(key)
    prior = jax.random.gumbel(k_gum, (HORIZON, T * B_RANK, S, D))
    steps = [k0] + list(jax.random.split(key, HORIZON))
    heads = [[] for _ in ACTIONS]
    for k in steps:
        for j, kh in enumerate(jax.random.split(k, len(ACTIONS))):
            heads[j].append(np.asarray(jax.random.gumbel(kh, (T * B_RANK, ACTIONS[j]))))
    return {"posterior": np.array(posterior), "prior": np.array(prior), "actions": [np.stack(h) for h in heads]}


@pytest.fixture(scope="module")
def runs():
    fabric = Fabric(devices=RANKS, accelerator="cpu")
    jcfg = compose(
        overrides=["exp=dreamer_v3_100k_ms_pacman", "env=dummy", "metric.log_level=0"]
        + [f"{k}={v}" for k, v in SMALL.items()]
    )
    space = gym.spaces.Dict({"rgb": gym.spaces.Box(0, 255, (3, 64, 64), np.uint8)})
    wm, actor, critic, params = jit_build(jax_agent.build_agent, jcfg, ACTIONS, False, space, jax.random.PRNGKey(3))
    rng = np.random.RandomState(8)
    for tree in (params["world_model"]["reward_model"], params["critic"]):
        tree["head"]["kernel"] = jnp.asarray(0.3 * rng.randn(*tree["head"]["kernel"].shape).astype(np.float32))
    params["target_critic"] = jax.tree_util.tree_map(lambda p: 0.5 * p, params["critic"])
    txs = jax_dv3.build_optimizers_and_state(jcfg, params)
    train_fn = jax_dv3.build_train_fn(wm, actor, critic, *txs[:3], jcfg, fabric, ACTIONS, False)

    keys = list(jax.random.split(jax.random.PRNGKey(12), 2))
    batches = [global_batch(31), global_batch(32)]
    taus = [1.0, 0.02]
    state = jax.tree_util.tree_map(jnp.array, jax.device_get(txs[3]))
    jax_steps = []
    for batch, key, tau in zip(batches, keys, taus):
        state, metrics = train_fn(state, {k: jnp.asarray(v) for k, v in batch.items()}, key, jnp.float32(tau))
        jax_steps.append((jax.device_get(state), jax.device_get(metrics)))

    state_dicts, skipped = convert_dreamer_v3(jax.device_get(params), training=True)
    assert skipped == []
    state_dicts = {name: {k: v.numpy() for k, v in sd.items()} for name, sd in state_dicts.items()}
    outs = spawn(
        ddp_ranks.dreamer_steps, RANKS, fabric_kwargs={"accelerator": "cpu"},
        args=("dreamer_v3", SMALL, ACTIONS, state_dicts, [halves(b) for b in batches],
              [[rank_noise(k, r) for r in range(RANKS)] for k in keys], taus),
    )
    return jax_steps, outs


def check_metrics(metrics, j_metrics):
    assert set(metrics) == set(j_metrics)
    for name, value in metrics.items():
        np.testing.assert_allclose(value, float(j_metrics[name]), **METRIC_TOL, err_msg=name)


def check_state(snap, j_state, param_atol):
    after, _ = convert_dreamer_v3(j_state["params"], training=True)
    for name in MODULES:
        for pname, value in snap["params"][name].items():
            np.testing.assert_allclose(value, after[name][pname].numpy(), rtol=0, atol=param_atol,
                                       err_msg=f"{name}.{pname}")
    for name in MODULES[:3]:
        moments, _ = convert_dreamer_v3({**j_state["params"], name: _first_moments(j_state["opt"][name])},
                                        training=True)
        for pname, got in snap["exp_avg"][name].items():
            want = moments[name][pname].numpy() / 0.1
            np.testing.assert_allclose(got / 0.1, want, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL_OF_MAX * max(float(np.abs(want).max()), 1.0),
                                       err_msg=f"{name}.{pname} gradient")
    for k in ("low", "high"):
        np.testing.assert_allclose(snap["moments"][k], float(j_state["moments"][k]), **METRIC_TOL)


def assert_replicas(a, b):
    """Two ranks' snapshots are bitwise equal."""
    for name in MODULES:
        for pname in a["params"][name]:
            np.testing.assert_array_equal(a["params"][name][pname], b["params"][name][pname], err_msg=pname)
    for name in MODULES[:3]:
        for pname in a["exp_avg"][name]:
            np.testing.assert_array_equal(a["exp_avg"][name][pname], b["exp_avg"][name][pname], err_msg=pname)
    assert a["moments"] == b["moments"] and a["metrics"] == b["metrics"]


@pytest.mark.parametrize("step", [0, 1])
def test_each_step_on_two_ranks_matches_the_jax_step_on_two_devices(runs, step):
    jax_steps, outs = runs
    j_state, j_metrics = jax_steps[step]
    snap = outs[0]["steps"][step]
    check_metrics(snap["metrics"], j_metrics)
    check_state(snap, j_state, PARAM_ATOL if step == 0 else BURST_PARAM_ATOL)
    assert_replicas(snap, outs[1]["steps"][step])


def test_a_two_step_burst_on_two_ranks_matches_the_jax_steps(runs):
    jax_steps, outs = runs
    j_state, j_metrics = jax_steps[-1]
    check_metrics(outs[0]["burst"]["metrics"], j_metrics)
    check_state(outs[0]["burst"], j_state, BURST_PARAM_ATOL)
    assert_replicas(outs[0]["burst"], outs[1]["burst"])
    assert outs[0]["burst_eager_calls"] == 2  # the CPU runs the burst's body eagerly


def test_the_ranks_load_no_jax(runs):
    _jax_steps, outs = runs
    assert [o["modules"] for o in outs] == [[], []]

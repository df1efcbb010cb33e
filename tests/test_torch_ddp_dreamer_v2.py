"""The port's DreamerV2 step on two data-parallel ranks against the JAX
package's step on two devices, on the CPU.

The JAX step runs on a two-device ``Fabric`` (two of the conftest's
virtual devices): the batch ``[T, 2·B, ...]`` split over the ``data``
axis, each device's noise from ``fold_in(key, axis_index)``
(``sheeprl_tpu/algos/dreamer_v2/dreamer_v2.py``), the gradients and the
metrics ``pmean``'d. The port's two gloo ranks (spawned,
``tests/ddp_ranks.py``) each get their half of the batch and the noise
JAX's key schedule gives their device, re-derived here as
``tests/test_torch_dreamer_v2_train.py`` does for one device, from the
same converted weights; one step at τ = 0 (the target kept) and one at
τ = 1 (the critic copied), each from the starting weights.

Tolerances are ``tests/test_torch_dreamer_v2_train.py``'s: losses and
metrics rtol 1e-4 and atol 1e-6, gradients (the optimizers' first moments)
rtol 1e-3 and atol 1e-5, parameters atol 2e-6. The two ranks' parameters,
optimizer state and metrics are bitwise equal after each step.
"""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax_jit_build import jit_build
from test_torch_dreamer_v2_train import ACTIONS, GRAD_TOL, HORIZON, METRIC_TOL, PARAM_ATOL, SMALL, D, S, T, _first_moments

import cpu_threads  # noqa: F401  (one CPU thread a process)
import ddp_ranks
from sheeprl_tpu.algos.dreamer_v2 import agent as jax_agent
from sheeprl_tpu.algos.dreamer_v2 import dreamer_v2 as jax_dv2
from sheeprl_tpu.config import compose
from sheeprl_tpu.fabric import Fabric
from sheeprl_tpu_torch.convert import convert_dreamer_v2
from sheeprl_tpu_torch.parallel import spawn

RANKS, B_RANK = 2, 3
MODULES = ddp_ranks.MODULES
TAUS = (0.0, 1.0)


@pytest.fixture(autouse=True, scope="module")
def restore_prng_impl():
    saved = jax.config.jax_default_prng_impl
    yield
    jax.config.update("jax_default_prng_impl", saved)


def global_batch(seed=21):
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
        "rewards": rng.randn(T, n, 1).astype(np.float32),
        "dones": dones,
        "is_first": is_first,
    }


def rank_noise(key, rank):
    """Device ``rank``'s noise in the JAX step (its key ``fold_in(key, rank)``)."""
    key = jax.random.fold_in(key, rank)
    k_wm, k_img = jax.random.split(key)
    posterior = jax.random.gumbel(k_wm, (T, B_RANK, S, D))
    k_gum, k_steps = jax.random.split(k_img)
    prior = jax.random.gumbel(k_gum, (HORIZON, T * B_RANK, S, D))
    heads = [[] for _ in ACTIONS]
    for k in jax.random.split(k_steps, HORIZON):
        for j, kh in enumerate(jax.random.split(k, len(ACTIONS))):
            heads[j].append(np.asarray(jax.random.gumbel(kh, (T * B_RANK, ACTIONS[j]))))
    return {"posterior": np.array(posterior), "prior": np.array(prior), "actions": [np.stack(h) for h in heads]}


@pytest.fixture(scope="module")
def runs():
    fabric = Fabric(devices=RANKS, accelerator="cpu")
    jcfg = compose(
        overrides=["exp=dreamer_v2_ms_pacman", "metric.log_level=0"] + [f"{k}={v}" for k, v in SMALL.items()]
    )
    space = gym.spaces.Dict({"rgb": gym.spaces.Box(0, 255, (3, 64, 64), np.uint8)})
    wm, actor, critic, params = jit_build(jax_agent.build_agent, jcfg, ACTIONS, False, space, jax.random.PRNGKey(3))
    params["target_critic"] = jax.tree_util.tree_map(lambda p: 0.5 * p, params["target_critic"])
    txs = jax_dv2.build_optimizers_and_state(jcfg, params)
    train_fn = jax_dv2.build_train_fn(wm, actor, critic, *txs[:3], jcfg, fabric, ACTIONS, False)
    key, batch = jax.random.PRNGKey(11), global_batch()
    jax_steps = []
    for tau in TAUS:
        state = jax.tree_util.tree_map(jnp.array, jax.device_get(txs[3]))  # the step donates its state
        state, metrics = train_fn(state, {k: jnp.asarray(v) for k, v in batch.items()}, key, jnp.float32(tau))
        jax_steps.append((jax.device_get(state), jax.device_get(metrics)))

    state_dicts, skipped = convert_dreamer_v2(jax.device_get(params), training=True)
    assert skipped == []
    state_dicts = {name: {k: v.numpy() for k, v in sd.items()} for name, sd in state_dicts.items()}
    halves = [{k: np.ascontiguousarray(v[:, r * B_RANK:(r + 1) * B_RANK]) for k, v in batch.items()}
              for r in range(RANKS)]
    noise = [rank_noise(key, r) for r in range(RANKS)]
    outs = spawn(ddp_ranks.dreamer_steps, RANKS, fabric_kwargs={"accelerator": "cpu"},
                 args=("dreamer_v2", SMALL, ACTIONS, state_dicts, [halves] * len(TAUS), [noise] * len(TAUS),
                       list(TAUS)), kwargs={"independent": True})
    return jax_steps, outs


@pytest.mark.parametrize("step", range(len(TAUS)), ids=[f"tau{t}" for t in TAUS])
def test_the_step_on_two_ranks_matches_the_jax_step_on_two_devices(runs, step):
    jax_steps, outs = runs
    new_state, j_metrics = jax_steps[step]
    snap = outs[0]["steps"][step]
    assert set(snap["metrics"]) <= set(j_metrics)
    for name, value in snap["metrics"].items():
        np.testing.assert_allclose(value, float(j_metrics[name]), **METRIC_TOL, err_msg=name)
    after, _ = convert_dreamer_v2(new_state["params"], training=True)
    for name in MODULES[:3]:
        moments, _ = convert_dreamer_v2({**new_state["params"], name: _first_moments(new_state["opt"][name])},
                                        training=True)
        for pname, got in snap["exp_avg"][name].items():
            np.testing.assert_allclose(got / 0.1, moments[name][pname].numpy() / 0.1, **GRAD_TOL,
                                       err_msg=f"{name}.{pname} gradient")
    for name in MODULES:
        for pname, value in snap["params"][name].items():
            np.testing.assert_allclose(value, after[name][pname].numpy(), rtol=0, atol=PARAM_ATOL,
                                       err_msg=f"{name}.{pname}")
    other = outs[1]["steps"][step]
    for name in MODULES:
        for pname, value in snap["params"][name].items():
            np.testing.assert_array_equal(value, other["params"][name][pname], err_msg=pname)
    for name in MODULES[:3]:
        for pname, value in snap["exp_avg"][name].items():
            np.testing.assert_array_equal(value, other["exp_avg"][name][pname], err_msg=pname)
    assert snap["metrics"] == other["metrics"]


def test_the_ranks_load_no_jax(runs):
    assert [o["modules"] for o in runs[1]] == [[], []]

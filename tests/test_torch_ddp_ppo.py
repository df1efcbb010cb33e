"""The port's PPO update on two data-parallel ranks against the JAX
package's update on two devices, on the CPU, with ``buffer.share_data``
off and on.

The JAX update (``build_update_fn`` on a two-device ``Fabric``, two of the
conftest's virtual devices) runs inside a ``shard_map``: without
``share_data`` each device takes its half of the rollout rows and permutes
them with ``split(fold_in(key, device index), epochs)``; with it every
device holds all the rows, draws one global permutation a epoch from
``split(key, epochs)`` and trains on its slice of it. Either way the
advantages are normalised over each device's minibatch, the gradients
``pmean``'d a minibatch and the metrics ``pmean``'d after the scan. The
port's two gloo ranks (``tests/ddp_ranks.py``) get the same weights, their
own rows (gathered from both ranks with ``share_data``,
``ppo.gather_rows``) and those permutations.

Tolerances are ``tests/test_torch_ppo.py``'s: the mean losses within 1e-5
relative; Adam's moments within 1e-5 relative (L2 over each tensor), the
second in the gradient's units; the parameters within 1e-5 relative, and
within ``2·lr`` a step where the JAX first moment lies within 1e-7 of
zero. The two ranks' parameters and optimizer state are bitwise equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_ppo import (
    ACTIONS,
    BS,
    EPOCHS,
    FEAT,
    N_LOCAL,
    OBS_KINDS,
    STATE,
    UNITS,
    agents,
    rollout_batch,
    update_overrides,
)

import cpu_threads  # noqa: F401  (one CPU thread a process)
import ddp_ranks
from sheeprl_tpu.algos.ppo import ppo as jax_ppo
from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.config.instantiate import instantiate as jax_instantiate
from sheeprl_tpu.fabric import Fabric
from sheeprl_tpu_torch.convert import convert_optax_state, convert_ppo
from sheeprl_tpu_torch.parallel import spawn

RANKS = 2
KIND, ACTION = "pixels_and_mlp", "discrete"
EXTRA = ("algo.normalize_advantages=True", "algo.clip_vloss=True", "algo.max_grad_norm=0.5")


@pytest.fixture(autouse=True, scope="module")
def restore_prng_impl():
    saved = jax.config.jax_default_prng_impl
    yield
    jax.config.update("jax_default_prng_impl", saved)


@pytest.fixture(scope="module", params=[False, True], ids=["per_rank_data", "share_data"])
def runs(request):
    share = request.param
    j, params, _port = agents(KIND, ACTION, key=2)
    overrides = update_overrides(KIND, EXTRA) + [f"buffer.share_data={share}"]
    data = rollout_batch(5, KIND, ACTION, n=RANKS * N_LOCAL)
    fabric = Fabric(devices=RANKS, accelerator="cpu")
    jcfg = jax_compose(overrides=["exp=ppo"] + overrides)
    tx = jax_instantiate(jcfg.algo.optimizer, max_grad_norm=jcfg.algo.max_grad_norm or None)
    update = jax_ppo.build_update_fn(j, tx, jcfg, fabric, N_LOCAL)
    key = jax.random.PRNGKey(9)
    new_params, new_opt, j_metrics = update(jax.tree_util.tree_map(jnp.array, params), tx.init(params),
                                            {k: jnp.asarray(v) for k, v in data.items()}, key, jnp.float32(0.2),
                                            jnp.float32(0.01))
    if share:
        perms = [np.asarray(jax.random.permutation(k, RANKS * N_LOCAL)) for k in jax.random.split(key, EPOCHS)]
    else:
        perms = [[np.asarray(jax.random.permutation(k, N_LOCAL))
                  for k in jax.random.split(jax.random.fold_in(key, r), EPOCHS)] for r in range(RANKS)]
    cnn, mlp = OBS_KINDS[KIND]
    actions_dim, is_continuous = ACTIONS[ACTION]
    widths = dict(cnn_features_dim=FEAT, mlp_features_dim=FEAT, encoder_dense_units=UNITS, actor_dense_units=UNITS,
                  critic_dense_units=UNITS)
    rows = [{k: np.ascontiguousarray(v[r * N_LOCAL:(r + 1) * N_LOCAL]) for k, v in data.items()} for r in range(RANKS)]
    outs = spawn(ddp_ranks.ppo_update, RANKS, fabric_kwargs={"accelerator": "cpu"},
                 args=(overrides, (actions_dim, is_continuous, cnn, mlp, 3 if cnn else 0, STATE), widths,
                       {k: v.numpy() for k, v in convert_ppo(jax.device_get(params)).items()}, rows, perms, share,
                       N_LOCAL, BS, EPOCHS))
    lr = float(jcfg.algo.optimizer.lr)
    return share, jax.device_get(new_params), jax.device_get(new_opt), np.asarray(j_metrics), outs, lr


def test_the_update_on_two_ranks_matches_the_jax_update_on_two_devices(runs):
    share, new_params, new_opt, j_metrics, outs, lr = runs
    out = outs[0]
    assert out["rows"]["actions"] == (RANKS * N_LOCAL if share else N_LOCAL)
    np.testing.assert_allclose(out["metrics"], j_metrics, rtol=1e-5, atol=1e-7)
    names = list(out["params"])
    want_state = convert_optax_state(new_opt, convert_ppo, names)["state"]
    after = convert_ppo(new_params)
    n_steps = EPOCHS * (N_LOCAL // BS)
    for i, name in enumerate(names):
        state = out["opt"][i]
        for k, unit in (("exp_avg", lambda m: m), ("exp_avg_sq", np.sqrt)):
            want = unit(want_state[i][k].numpy().astype(np.float64))
            dist = np.linalg.norm(unit(state[k].astype(np.float64)) - want) / max(np.linalg.norm(want), 1e-30)
            assert dist <= 1e-5, f"{name} {k}: relative L2 distance {dist}"
        assert float(state["step"]) == float(want_state[i]["step"]) == n_steps
        want = after[name].numpy().astype(np.float64)
        near_zero = np.abs(want_state[i]["exp_avg"].numpy()) <= 1e-7
        diff = np.abs(out["params"][name] - want)
        assert (diff[near_zero] <= 2 * lr * n_steps).all(), f"{name}: {diff[near_zero].max()}"
        dist = np.linalg.norm(diff[~near_zero]) / max(np.linalg.norm(want[~near_zero]), 1e-30)
        assert dist <= 1e-5, f"{name}: relative L2 distance {dist}"


def test_the_ranks_are_bitwise_replicas_and_load_no_jax(runs):
    outs = runs[4]
    for name, value in outs[0]["params"].items():
        np.testing.assert_array_equal(value, outs[1]["params"][name], err_msg=name)
    for a, b in zip(outs[0]["opt"], outs[1]["opt"]):
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
    np.testing.assert_array_equal(outs[0]["metrics"], outs[1]["metrics"])
    assert [o["modules"] for o in outs] == [[], []]

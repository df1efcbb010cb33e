"""The port's PPO-recurrent against the JAX package on the CPU.

- The LSTM cell (``models.LSTMCell``, flax's ``nn.OptimizedLSTMCell`` in
  PyTorch operations) and the reset-aware scan over a sequence whose
  ``is_first`` is set mid-sequence, against the JAX ``_ResetLSTMCell``
  under ``nn.scan``: atol 1e-5 on every output and the final carry.
- The agent over T = 8 sequences (heads, values, carry): atol 1e-5.
- One whole update (AdamW, ``max_grad_norm=0.5``, normalized advantages,
  the clipped value loss, 2 epochs × 2 minibatches of sequences) at the JAX
  update's own permutations: the tolerances of ``tests/test_torch_ppo.py``.
- ``MaskVelocityWrapper`` against the JAX wrapper on gymnasium's CartPole:
  the same observations, bit for bit.
"""

from __future__ import annotations

import flax.linen as fnn
import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.ppo_recurrent import agent as jax_agent
from sheeprl_tpu.algos.ppo_recurrent import ppo_recurrent as jax_ppo_recurrent
from sheeprl_tpu.envs.wrappers import MaskVelocityWrapper as JaxMaskVelocityWrapper
from sheeprl_tpu.fabric import Fabric
from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.config.instantiate import instantiate as jax_instantiate
from sheeprl_tpu_torch.algos.ppo.ppo import UpdateProgram, build_optimizer, ppo_loss
from sheeprl_tpu_torch.algos.ppo_recurrent.agent import RecurrentPPOAgent, ResetLSTM
from sheeprl_tpu_torch.algos.ppo_recurrent.ppo_recurrent import recurrent_forward, select_sequences, to_hc, to_seq
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.convert import convert_ppo_recurrent
from sheeprl_tpu_torch.envs.wrappers import GymnasiumEnv, MaskVelocityWrapper
from sheeprl_tpu_torch.utils.optim import AdamW
from test_torch_ppo import OUT_TOL, _t, check_update

T, B, X, H, STATE, ACT = 8, 4, 6, 8, 5, 2


@pytest.fixture(autouse=True, scope="module")
def restore_prng_impl():
    """The JAX Fabric switches JAX's default key implementation for the
    whole process (to ``rbg``): put it back after the module, so that a
    later file on the same worker draws the keys it expects."""
    saved = jax.config.jax_default_prng_impl
    yield
    jax.config.update("jax_default_prng_impl", saved)


def test_lstm_cell_and_resets_match_flax():
    scan = fnn.scan(jax_agent._ResetLSTMCell, variable_broadcast="params", split_rngs={"params": False}, in_axes=0,
                    out_axes=0)(H)
    rng = np.random.RandomState(0)
    x = rng.randn(T, B, X).astype(np.float32)
    first = np.zeros((T, B, 1), np.float32)
    first[0, 0] = first[3, 1] = first[5, 2] = first[5, 3] = 1.0
    hc = (rng.randn(B, H).astype(np.float32), rng.randn(B, H).astype(np.float32))
    variables = scan.init(jax.random.PRNGKey(1), hc, (x, first))
    (j_c, j_h), j_out = scan.apply(variables, hc, (x, first))
    cell = variables["params"]["OptimizedLSTMCell_0"]
    port = ResetLSTM(X, H)
    converted = convert_ppo_recurrent({"rnn": {"OptimizedLSTMCell_0": jax.device_get(cell)}})
    port.cell.load_state_dict({k.split("rnn.cell.", 1)[1]: v for k, v in converted.items()})
    out, (c, h) = port(_t(x), _t(first), (_t(hc[0]), _t(hc[1])))
    np.testing.assert_allclose(out.detach().numpy(), j_out, **OUT_TOL)
    np.testing.assert_allclose(c.detach().numpy(), j_c, **OUT_TOL)
    np.testing.assert_allclose(h.detach().numpy(), j_h, **OUT_TOL)
    # a reset really cuts the history: env 1 from step 3 on is a fresh start
    fresh, _ = port(_t(x[3:, 1:2]), _t(first[3:, 1:2]), (torch.zeros(1, H), torch.zeros(1, H)))
    np.testing.assert_allclose(out[3:, 1:2].detach().numpy(), fresh.detach().numpy(), rtol=0, atol=1e-6)


WIDTHS = dict(mlp_features_dim=8, encoder_dense_units=8, rnn_hidden_size=H, actor_dense_units=16,
              critic_dense_units=16)


def agents(pre_post: bool, key: int = 0):
    j = jax_agent.RecurrentPPOAgent(actions_dim=(ACT,), is_continuous=False, cnn_keys=(), mlp_keys=("state",),
                                    screen_size=64, encoder_mlp_layers=1, pre_rnn_apply=pre_post,
                                    post_rnn_apply=pre_post, pre_rnn_dense_units=8, post_rnn_dense_units=8, **WIDTHS)
    params = jax.device_get(j.init(jax.random.PRNGKey(key), {"state": jnp.zeros((1, 1, STATE))},
                                   jnp.zeros((1, 1, ACT)), jnp.zeros((1, 1, 1)), j.initial_hc(1))["params"])
    port = RecurrentPPOAgent((ACT,), False, (), ("state",), 0, STATE, encoder_mlp_layers=1, pre_rnn_apply=pre_post,
                             post_rnn_apply=pre_post, pre_rnn_dense_units=8, post_rnn_dense_units=8, **WIDTHS)
    port.load_state_dict(convert_ppo_recurrent(params))
    return j, params, port


def sequences(seed: int, n: int = B):
    rng = np.random.RandomState(seed)
    first = (rng.uniform(size=(T, n, 1)) < 0.15).astype(np.float32)
    first[0] = 1.0
    prev = np.eye(ACT, dtype=np.float32)[rng.randint(0, ACT, (T, n))] * (1.0 - first)
    return {"state": rng.randn(T, n, STATE).astype(np.float32), "prev_actions": prev, "is_first": first,
            "hc": (rng.randn(n, H).astype(np.float32) * 0.5, rng.randn(n, H).astype(np.float32) * 0.5)}


@pytest.mark.parametrize("pre_post", [False, True])
def test_agent_over_sequences_matches_jax(pre_post):
    j, params, port = agents(pre_post)
    s = sequences(1)
    j_pre, j_values, (j_c, j_h) = j.apply({"params": params}, {"state": s["state"]}, s["prev_actions"],
                                          s["is_first"], s["hc"])
    pre, values, (c, h) = port({"state": _t(s["state"])}, _t(s["prev_actions"]), _t(s["is_first"]),
                               (_t(s["hc"][0]), _t(s["hc"][1])))
    for a, b in zip(pre, j_pre):
        np.testing.assert_allclose(a.detach().numpy(), b, **OUT_TOL)
    for a, b in ((values, j_values), (c, j_c), (h, j_h)):
        np.testing.assert_allclose(a.detach().numpy(), b, **OUT_TOL)


N_SEQ, EPOCHS = 8, 2


def test_update_matches_jax():
    """One whole recurrent update with the preset's AdamW, its clip at 0.5,
    normalized advantages and the clipped value loss: 2 epochs × 2
    minibatches of 4 sequences of 8 steps."""
    j, params, port = agents(False, key=4)
    overrides = ["exp=ppo_recurrent", "algo.encoder.mlp_features_dim=8", "algo.encoder.dense_units=8",
                 f"algo.rnn.lstm.hidden_size={H}", "algo.dense_units=16", f"algo.update_epochs={EPOCHS}",
                 "per_rank_num_batches=2", f"per_rank_sequence_length={T}", "mlp_keys.encoder=[state]"]
    s = sequences(2, N_SEQ)
    rng = np.random.RandomState(3)
    actions = np.eye(ACT, dtype=np.float32)[rng.randint(0, ACT, (T, N_SEQ))]
    data = {"state": s["state"], "prev_actions": s["prev_actions"], "is_first": s["is_first"], "actions": actions,
            **{k: (rng.randn(T, N_SEQ, 1) * sc).astype(np.float32) for k, sc in (("logprobs", 0.5), ("values", 1.0),
                                                                                 ("returns", 1.0),
                                                                                 ("advantages", 1.0))}}
    fabric = Fabric(devices=1, accelerator="cpu")
    jcfg = jax_compose(overrides=overrides)
    tx = jax_instantiate(jcfg.algo.optimizer, max_grad_norm=jcfg.algo.max_grad_norm or None)
    update = jax_ppo_recurrent.build_update_fn(j, tx, jcfg, fabric, N_SEQ)
    key = jax.random.PRNGKey(12)
    outs = update(jax.tree_util.tree_map(jnp.array, params), tx.init(params),
                  {k: jnp.asarray(v) for k, v in data.items()}, {"c": jnp.asarray(s["hc"][0]),
                                                                 "h": jnp.asarray(s["hc"][1])},
                  key, jnp.float32(0.2), jnp.float32(0.001))
    perms = [np.asarray(jax.random.permutation(k, N_SEQ)) for k in jax.random.split(jax.random.fold_in(key, 0),
                                                                                     EPOCHS)]
    cfg = compose(overrides=overrides)
    optimizer = build_optimizer(cfg, port)
    assert isinstance(optimizer, AdamW) and float(cfg.algo.max_grad_norm) == 0.5
    program = UpdateProgram(ppo_loss(cfg, [], ["state"], (ACT,), False, forward=recurrent_forward), select_sequences,
                            port, optimizer, max_grad_norm=0.5, epochs=EPOCHS, n_samples=N_SEQ, batch_size=N_SEQ // 2,
                            n_metrics=3, n_scalars=2, generator=None, device="cpu")
    metrics = program.update({**data, "hc_c": s["hc"][0], "hc_h": s["hc"][1]}, [0.2, 0.001], perms=perms)
    np.testing.assert_allclose(metrics.numpy(), np.asarray(outs[2]), rtol=1e-5, atol=1e-7)
    check_update(port, optimizer, jax.device_get(outs[0]), jax.device_get(outs[1]), float(cfg.algo.optimizer.lr),
                 EPOCHS * 2, converter=convert_ppo_recurrent)


def test_sequence_chunks_keep_the_jax_order():
    """``to_seq`` cuts ``[T, E]`` into env-major chunks of L steps and
    ``to_hc`` gives each chunk the state its first step started from (the
    JAX ``main``'s ``to_seq`` and ``to_hc``): chunk ``e·(T/L) + k`` is env
    e's steps ``k·L .. k·L + L − 1``."""
    steps, envs, L = 8, 3, 4
    x = np.arange(steps * envs).reshape(steps, envs, 1).astype(np.float32)
    seq = to_seq(x, L)
    assert seq.shape == (L, envs * 2, 1)
    for e in range(envs):
        for k in range(2):
            np.testing.assert_array_equal(seq[:, e * 2 + k, 0], x[k * L:(k + 1) * L, e, 0])
    np.testing.assert_array_equal(to_seq(torch.from_numpy(x), L).numpy(), seq)
    hc = np.arange(steps * envs * 2).reshape(steps, envs, 2).astype(np.float32)
    np.testing.assert_array_equal(to_hc(hc, L)[3], hc[4, 1])


def test_mask_velocity_wrapper_matches_jax():
    port = MaskVelocityWrapper(GymnasiumEnv(gym.make("CartPole-v1")))
    ref = JaxMaskVelocityWrapper(gym.make("CartPole-v1"))
    a, _ = port.reset(seed=3)
    b, _ = ref.reset(seed=3)
    np.testing.assert_array_equal(a, b)
    assert a[1] == 0.0 and a[3] == 0.0
    for t in range(40):
        out_a, out_b = port.step(t % 2), ref.step(t % 2)
        np.testing.assert_array_equal(out_a[0], out_b[0])
        assert out_a[1:4] == out_b[1:4]
        if out_a[2] or out_a[3]:
            break
    with pytest.raises(NotImplementedError, match="Velocity masking not implemented"):
        MaskVelocityWrapper(GymnasiumEnv(gym.make("Acrobot-v1")))

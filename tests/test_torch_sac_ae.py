"""The port's SAC-AE against the JAX package on the CPU.

Both sides get the same weights (the JAX ``build_agent``'s, carried across
by ``convert_sac_ae(..., training=True)``: convolutions HWIO → OIHW, the
projection flattened NHWC, the transposed convolutions by the same
transpose), the same numpy batch (64×64 pixels, 3 channels, and a vector
key, so both encoders and both decoders run) and the same noise, re-derived
from the step's key as ``local_train`` and ``one_step`` split it: the G
step keys, each split into the critic's, the actor's and the decoder's key;
the two samples' normals at ``[B, A]``; the decoder key split once a CNN
decoder key, a uniform of the pixels' shape each.

Tolerances (float32 on the CPU; XLA's and PyTorch's convolutions sum in
other orders):

- the encoder's features and the decoder's reconstructions: atol 1e-5;
  ``preprocess_obs``: atol 1e-6;
- one update at each cadence: the critic, alpha and reconstruction losses
  at rtol 1e-4, atol 1e-5; the actor's at atol 1e-2 (its samples reach the
  saturated tanh, where one float32 ulp of tanh moves a log-prob by ≈ 0.02,
  as in ``test_torch_sac.py``);
- the parameters after the update: atol 5e-6, and 2·lr where the JAX
  gradient lies within 1e-5 of zero (the encoder's two steps: 2·(lr + lr)
  where either gradient does); the targets: atol 5e-6.

The init is a distribution, held by its statistics: orthogonal Linear
weights and convolution centre taps (``W·Wᵀ`` or ``Wᵀ·W`` the identity
within 1e-5), zero off-centre taps and biases, and the stacked Q-functions'
LeCun-normal std within 10% of the JAX init's.
"""

from __future__ import annotations

import functools

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_jit_build import jit_build

from sheeprl_tpu.algos.sac.agent import action_bounds as jax_action_bounds
from sheeprl_tpu.algos.sac_ae import agent as jax_agent
from sheeprl_tpu.algos.sac_ae import sac_ae as jax_sac_ae
from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.config.instantiate import instantiate as jax_instantiate
from sheeprl_tpu_torch.algos.sac_ae import sac_ae
from sheeprl_tpu_torch.algos.sac_ae.agent import build_agent, preprocess_obs
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.convert import convert_sac_ae, convert_sac_ae_encoder
from sheeprl_tpu_torch.envs import spaces
from test_torch_dreamer_v2_train import _first_moments
from test_torch_sac import _t, jax_fabric, restore_prng_impl  # noqa: F401  (a module fixture)

ACT, B, VEC = 2, 4, 5
SMALL = ["algo.hidden_size=16", "algo.dense_units=8", "algo.encoder.features_dim=8",
         "algo.cnn_channels_multiplier=1", f"per_rank_batch_size={B}", "metric.log_level=0",
         "cnn_keys.encoder=[rgb]", "cnn_keys.decoder=[rgb]", "mlp_keys.encoder=[state]", "mlp_keys.decoder=[state]"]
LOW, HIGH = np.array([-1.0, -2.0], np.float32), np.array([1.0, 2.0], np.float32)
OPT_OF = {"qfs": "qf", "actor": "actor", "decoder": "decoder"}


def gym_space():
    return gym.spaces.Dict({"rgb": gym.spaces.Box(0, 255, (3, 64, 64), np.uint8),
                            "state": gym.spaces.Box(-np.inf, np.inf, (VEC,), np.float32)})


def port_space():
    return spaces.Dict({"rgb": spaces.Box(0, 255, (3, 64, 64), np.uint8),
                        "state": spaces.Box(-np.inf, np.inf, (VEC,), np.float32)})


@functools.lru_cache(maxsize=None)
def jax_side():
    jax_fabric()
    jcfg = jax_compose(overrides=["exp=sac_ae"] + SMALL)
    encoder, decoder, qf, actor, params = jit_build(jax_agent.build_agent, jcfg, ACT, gym_space(), jax.random.PRNGKey(3))
    txs = {k: jax_instantiate(jcfg.algo[n].optimizer) for k, n in (("qf", "critic"), ("actor", "actor"),
                                                                   ("alpha", "alpha"), ("encoder", "encoder"),
                                                                   ("decoder", "decoder"))}
    opts = {"qf": txs["qf"].init({"encoder": params["encoder"], "qfs": params["qfs"]}),
            "actor": txs["actor"].init(params["actor"]), "alpha": txs["alpha"].init(params["log_alpha"]),
            "encoder": txs["encoder"].init(params["encoder"]), "decoder": txs["decoder"].init(params["decoder"])}
    scale, bias = jax_action_bounds(gym.spaces.Box(LOW, HIGH))
    train = jax_sac_ae.build_train_fn(encoder, decoder, qf, actor, txs, jcfg, jax_fabric(), scale, bias, -float(ACT))
    return dict(encoder=encoder, decoder=decoder, params=jax.device_get(params), opts=jax.device_get(opts),
                train=train, scale=scale, bias=bias)


def pixel_batch(seed: int, g: int = 1):
    rng = np.random.RandomState(seed)
    return {
        "rgb": rng.randint(0, 256, (g, B, 3, 64, 64)).astype(np.uint8),
        "state": rng.randn(g, B, VEC).astype(np.float32),
        "next_rgb": rng.randint(0, 256, (g, B, 3, 64, 64)).astype(np.uint8),
        "next_state": rng.randn(g, B, VEC).astype(np.float32),
        "actions": rng.uniform(LOW, HIGH, (g, B, ACT)).astype(np.float32),
        "rewards": rng.randn(g, B, 1).astype(np.float32),
        "dones": (rng.uniform(size=(g, B, 1)) < 0.25).astype(np.float32),
    }


def port_state(cfg, params, scale, bias):
    agent = build_agent(cfg, ACT, port_space(), None)
    converted, skipped = convert_sac_ae(params, training=True)
    assert skipped == []
    for name, module in agent.items():
        if name == "log_alpha":
            with torch.no_grad():
                module.copy_(converted[name])
        else:
            module.load_state_dict(converted[name])
    state = sac_ae.build_optimizers_and_state(cfg, agent)
    state["action_scale"], state["action_bias"] = torch.from_numpy(scale), torch.from_numpy(bias)
    return state


def test_encoder_and_decoder_match_jax():
    side = jax_side()
    params = side["params"]
    batch = pixel_batch(1)
    obs = {"rgb": batch["rgb"][0] / 255.0, "state": batch["state"][0]}
    feat = side["encoder"].apply({"params": params["encoder"]}, obs)
    recon = side["decoder"].apply({"params": params["decoder"]}, feat)
    cfg = compose(overrides=["exp=sac_ae"] + SMALL)
    agent = build_agent(cfg, ACT, port_space(), None)
    converted, _ = convert_sac_ae(params, training=True)
    agent["encoder"].load_state_dict(converted["encoder"])
    agent["decoder"].load_state_dict(converted["decoder"])
    got = agent["encoder"]({k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in obs.items()})
    np.testing.assert_allclose(got.detach().numpy(), feat, rtol=0, atol=1e-5)
    got_recon = agent["decoder"](torch.from_numpy(np.asarray(feat)))
    assert got_recon["rgb"].shape == (B, 3, 64, 64) and got_recon["state"].shape == (B, VEC)
    for k in ("rgb", "state"):
        np.testing.assert_allclose(got_recon[k].detach().numpy(), recon[k], rtol=0, atol=1e-5, err_msg=k)
    assert float(got_recon["rgb"][..., -1, :].abs().max()) == 0.0  # the JAX pad: zeros, no bias


def test_preprocess_obs_matches_jax():
    pixels = np.random.RandomState(2).randint(0, 256, (B, 3, 8, 8)).astype(np.uint8)
    key = jax.random.PRNGKey(4)
    want = jax_agent.preprocess_obs(jnp.asarray(pixels), bits=5, key=key)
    noise = jax.random.uniform(key, pixels.shape, jnp.float32)
    got = preprocess_obs(torch.from_numpy(pixels), bits=5, noise=_t(noise))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(preprocess_obs(torch.from_numpy(pixels)).numpy(),
                               jax_agent.preprocess_obs(jnp.asarray(pixels)), rtol=0, atol=1e-6)


def _orthogonal(w: np.ndarray) -> bool:
    gram = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
    return np.allclose(gram, np.eye(gram.shape[0]), atol=1e-5)


def test_weight_init_statistics():
    cfg = compose(overrides=["exp=sac_ae"] + SMALL)
    agent = build_agent(cfg, ACT, port_space(), torch.Generator().manual_seed(0))
    for name in ("encoder", "actor", "decoder"):
        for mname, m in agent[name].named_modules():
            if isinstance(m, torch.nn.Linear):
                assert _orthogonal(m.weight.detach().numpy()), f"{name}.{mname}"
            elif isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                w = m.weight.detach().numpy()
                assert _orthogonal(w[:, :, 1, 1]), f"{name}.{mname}"
                off = w.copy()
                off[:, :, 1, 1] = 0
                assert not off.any(), f"{name}.{mname}: off-centre taps"
            else:
                continue
            assert not m.bias.detach().numpy().any(), f"{name}.{mname}.bias"
    want_std = np.std(jax_side()["params"]["qfs"]["MLP_0"]["Dense_0"]["kernel"])
    got_std = float(agent["qfs"].blocks[0].linear.weight.std())
    assert abs(got_std / want_std - 1) < 0.1
    assert float(agent["log_alpha"]) == pytest.approx(np.log(0.1))


@pytest.mark.parametrize("do_ema,do_actor,do_decoder", [(True, True, True), (False, False, False), (True, False, True)])
def test_update_matches_jax(do_ema, do_actor, do_decoder):
    """One gradient step of both packages at one cadence: the gated-off
    parts keep their parameters and their optimizer state."""
    side = jax_side()
    batch = pixel_batch(5)
    key = jax.random.PRNGKey(17)
    copy = lambda tree: jax.tree_util.tree_map(jnp.array, tree)  # noqa: E731  (the program donates its state)
    gates = {"do_ema": jnp.bool_(do_ema), "do_actor": jnp.bool_(do_actor), "do_decoder": jnp.bool_(do_decoder)}
    new_params, new_opts, j_metrics = jax.device_get(side["train"](
        copy(side["params"]), copy(side["opts"]), {k: jnp.asarray(v) for k, v in batch.items()}, key, gates,
    ))
    c_key, a_key, d_key = jax.random.split(jax.random.split(key, 1)[0], 3)
    noise = {"next": _t(jax.random.normal(c_key, (B, ACT))), "actor": _t(jax.random.normal(a_key, (B, ACT))),
             "recon_rgb": _t(jax.random.uniform(jax.random.split(d_key, 1)[0], (B, 3, 64, 64), jnp.float32))}

    cfg = compose(overrides=["exp=sac_ae"] + SMALL)
    state = port_state(cfg, side["params"], side["scale"], side["bias"])
    program = sac_ae.build_train_fn(cfg, ACT, -float(ACT))
    metrics = program(state, {k: torch.from_numpy(v[0]) for k, v in batch.items()}, noise,
                      sac_ae.cadence_gates(cfg, do_ema, do_actor, do_decoder)).numpy()
    j_metrics = np.asarray(j_metrics)
    np.testing.assert_allclose(metrics[[0, 2, 3]], j_metrics[[0, 2, 3]], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(metrics[1], j_metrics[1], rtol=0, atol=1e-2)

    after, _ = convert_sac_ae(new_params, training=True)
    qf_mu = _first_moments(new_opts["qf"])
    grads = {name: convert_sac_ae({**new_params, name: qf_mu["qfs"] if name == "qfs" else _first_moments(new_opts[opt])},
                                  training=True)[0][name] for name, opt in OPT_OF.items()}
    for name in ("qfs", "actor", "decoder"):
        lr = float(cfg.algo[{"qfs": "critic"}.get(name, name)].optimizer.lr)
        for pname, p in state[name].named_parameters():
            want = grads[name][pname].numpy() / 0.1
            tol = np.where(np.abs(want) <= 1e-5, 2 * lr, 5e-6)
            diff = np.abs(p.detach().numpy() - after[name][pname].numpy())
            assert (diff <= tol).all(), f"{name}.{pname}: {diff.max()}"
    # the encoder takes two Adam steps (the critic's optimizer, then its own): either may turn a
    # rounding-sized gradient into ±lr
    lr = float(cfg.algo.encoder.optimizer.lr) + float(cfg.algo.critic.optimizer.lr)
    enc_grads = [convert_sac_ae_encoder(tree) for tree in (qf_mu["encoder"], _first_moments(new_opts["encoder"]))]
    for pname, p in state["encoder"].named_parameters():
        small = np.logical_or(*[np.abs(g[pname].numpy() / 0.1) <= 1e-5 for g in enc_grads])
        tol = np.where(small, 2 * lr, 5e-6)
        diff = np.abs(p.detach().numpy() - after["encoder"][pname].numpy())
        assert (diff <= tol).all(), f"encoder.{pname}: {diff.max()}"
    for name in ("target_encoder", "target_qfs"):
        for pname, p in state[name].named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), after[name][pname].numpy(), rtol=0, atol=5e-6,
                                       err_msg=f"{name}.{pname}")
    np.testing.assert_allclose(float(state["log_alpha"]), float(new_params["log_alpha"]), rtol=0, atol=2e-6)
    # a gated-off update leaves its parameters and its Adam state as they were
    actor_steps = int(state["opt"]["actor"].state[next(state["actor"].parameters())]["step"])
    decoder_steps = int(state["opt"]["decoder"].state[next(state["decoder"].parameters())]["step"])
    assert (actor_steps, decoder_steps) == (int(do_actor), int(do_decoder))
    if not do_actor:
        before, _ = convert_sac_ae(side["params"], training=True)
        for pname, p in state["actor"].named_parameters():
            assert torch.equal(p.detach(), before["actor"][pname])

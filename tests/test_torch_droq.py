"""The port's DroQ against the JAX package on the CPU.

Both sides get the same weights (``convert_droq``), the same numpy batches
and the same noise, at a dropout rate of 0.3 so that the masks matter. The
JAX ensemble draws one dropout key per member; this file reads each
member's masks out of flax itself: it applies the member under the same
key with an interceptor on ``nn.Dropout`` that runs the layer once on ones
(the mask is where the output is not 0) and returns ``where(mask, x /
keep, 0)``, flax's own formula. The update's other noise is re-derived from
its key as ``local_train`` and ``critic_step`` split it (``split(key, G +
2)``; each critic step's key into the next action's, the target's dropout
and the critics' dropout keys; the last two keys are the actor's sample and
its dropout).

Tolerances (float32 on the CPU):

- the ensemble's values with and without dropout: atol 1e-5;
- the update's losses: the mean critic loss over G and alpha's at rtol
  1e-4, atol 1e-5; the actor's at atol 1e-2: its samples reach |x| ≈ 7,
  where ``1 − tanh²`` is a few float32 ulps of tanh and one ulp moves a
  sample's log-prob by ≈ 0.02 (its gradient there is ≈ 0: the actor's
  parameters after the step hold at the tolerances below; the frameworks'
  policy losses differ by 5e-3 here);
- the parameters after the update (three critic steps, then the actor):
  atol 2e-5 (three Adam steps of float32 differences); the actor's and
  ``log_alpha`` after its one step: atol 2e-6, and 2·lr where the JAX
  gradient lies within 1e-5 of zero.
"""

from __future__ import annotations

import flax.linen as nn
import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import torch

from sheeprl_tpu.algos.droq import agent as jax_droq_agent
from sheeprl_tpu.algos.droq import droq as jax_droq
from sheeprl_tpu.algos.sac import agent as jax_sac_agent
from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.config.instantiate import instantiate as jax_instantiate
from sheeprl_tpu_torch.algos.droq import droq
from sheeprl_tpu_torch.algos.droq.agent import DROQCritic, draw_dropout_masks
from sheeprl_tpu_torch.algos.sac import sac
from sheeprl_tpu_torch.algos.sac.agent import action_bounds
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.convert import convert_critic_ensemble, convert_droq
from test_torch_dreamer_v2_train import _first_moments
from test_torch_sac import (  # noqa: F401  (restore_prng_impl: a module fixture)
    ACT,
    B,
    HIDDEN,
    HIGH,
    LOW,
    N,
    OBS,
    _t,
    jax_fabric,
    restore_prng_impl,
    transition_batch,
)

RATE, G = 0.3, 3
SMALL = [f"algo.hidden_size={HIDDEN}", f"per_rank_batch_size={B}", "metric.log_level=0",
         f"algo.critic.dropout={RATE}", f"algo.per_rank_gradient_steps={G}"]


def jax_critic_and_params(key=3):
    critic = jax_droq_agent.DROQCritic(hidden_size=HIDDEN, num_critics=1, dropout=RATE)
    params = jax_droq_agent.init_droq_ensemble(critic, jax.random.PRNGKey(key), N, OBS, ACT)
    return critic, jax.device_get(params)


def flax_masks(critic, stacked, obs, act, key) -> torch.Tensor:
    """Each member's dropout masks ``[layers, n, B, hidden]``, as
    ``droq_ensemble_q`` draws them from ``key``: under the same ``vmap``
    over the members' keys (the key implementation the JAX Fabric sets
    draws other bits under ``vmap`` than member by member)."""

    def member_masks(params, k):
        recorded = []

        def interceptor(next_fun, args, kwargs, context):
            if isinstance(context.module, nn.Dropout) and context.method_name == "__call__":
                x = args[0]
                mask = next_fun(jnp.ones_like(x), *args[1:], **kwargs) != 0
                recorded.append(mask)
                return jnp.where(mask, x / (1.0 - RATE), 0.0)
            return next_fun(*args, **kwargs)

        with nn.intercept_methods(interceptor):
            critic.apply({"params": params}, obs, act, deterministic=False, rngs={"dropout": k})
        return jnp.stack(recorded)

    masks = jax.vmap(member_masks)(stacked, jax.random.split(key, N))  # [n, layers, B, hidden]
    return torch.from_numpy(np.asarray(masks)).transpose(0, 1).contiguous()


def test_dropout_critic_matches_jax_with_the_masks_injected():
    jax_fabric()
    critic, params = jax_critic_and_params()
    rng = np.random.RandomState(2)
    obs, act = rng.randn(B, OBS).astype(np.float32), rng.randn(B, ACT).astype(np.float32)
    port = DROQCritic(N, OBS + ACT, HIDDEN, RATE)
    port.load_state_dict(convert_critic_ensemble(params))
    assert port.blocks[0].norm is not None  # LayerNorm on every hidden layer, as the JAX MLP
    key = jax.random.PRNGKey(9)
    masks = flax_masks(critic, params, obs, act, key)
    assert masks.shape == (2, N, B, HIDDEN) and 0.5 < masks.float().mean() < 0.9
    got = port(torch.from_numpy(obs), torch.from_numpy(act), masks)
    want = jax_droq_agent.droq_ensemble_q(critic, params, obs, act, key)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)
    deterministic = port(torch.from_numpy(obs), torch.from_numpy(act))
    np.testing.assert_allclose(deterministic.detach().numpy(), jax_droq_agent.droq_ensemble_q(critic, params, obs, act),
                               rtol=0, atol=1e-5)
    drawn = draw_dropout_masks(port, B, torch.Generator().manual_seed(0), "cpu", (4,))
    assert drawn.shape == (4, 2, N, B, HIDDEN) and abs(float(drawn.float().mean()) - (1 - RATE)) < 0.02


def test_update_matches_jax():
    """One DroQ update (G = 3 dropout critic steps with the target EMA after
    each, then the actor and alpha on a separate batch) of both packages."""
    jax_fabric()
    critic, critic_params = jax_critic_and_params()
    actor = jax_sac_agent.SACActor(action_dim=ACT, hidden_size=HIDDEN)
    params = {
        "actor": jax.device_get(actor.init(jax.random.PRNGKey(4), jnp.zeros((1, OBS)))["params"]),
        "critics": critic_params,
        "target_critics": jax.tree_util.tree_map(np.copy, critic_params),
        "log_alpha": np.log(np.asarray([1.0], np.float32)),
    }
    critic_batch = transition_batch(5, g=G)
    actor_obs = np.random.RandomState(6).randn(B, OBS).astype(np.float32)
    key = jax.random.PRNGKey(13)

    jcfg = jax_compose(overrides=["exp=droq"] + SMALL)
    txs = {k: jax_instantiate(jcfg.algo[n].optimizer) for k, n in (("actor", "actor"), ("qf", "critic"),
                                                                   ("alpha", "alpha"))}
    opts = {"actor": txs["actor"].init(params["actor"]), "qf": txs["qf"].init(params["critics"]),
            "alpha": txs["alpha"].init(params["log_alpha"])}
    scale, bias = action_bounds(gym.spaces.Box(LOW, HIGH))
    train = jax_droq.build_train_fn(actor, critic, txs["actor"], txs["qf"], txs["alpha"], jcfg, jax_fabric(),
                                    scale, bias, -float(ACT))
    copy = lambda tree: jax.tree_util.tree_map(jnp.array, tree)  # noqa: E731  (the program donates its state)
    new_params, new_opts, j_metrics = jax.device_get(train(
        copy(params), copy(opts), {k: jnp.asarray(v) for k, v in critic_batch.items()},
        {"observations": jnp.asarray(actor_obs)}, key,
    ))

    keys = jax.random.split(key, G + 2)
    noise = {"next": [], "target_masks": [], "masks": []}
    for i in range(G):
        next_key, tgt_key, drop_key = jax.random.split(keys[i], 3)
        noise["next"].append(_t(jax.random.normal(next_key, (B, ACT))))
        noise["target_masks"].append(flax_masks(critic, critic_params, critic_batch["next_observations"][i],
                                                critic_batch["actions"][i], tgt_key))
        noise["masks"].append(flax_masks(critic, critic_params, critic_batch["observations"][i],
                                         critic_batch["actions"][i], drop_key))
    noise = {k: torch.stack(v) for k, v in noise.items()}
    noise["actor"] = _t(jax.random.normal(keys[G], (B, ACT)))
    noise["actor_masks"] = flax_masks(critic, critic_params, actor_obs, np.zeros((B, ACT), np.float32), keys[G + 1])

    cfg = compose(overrides=["exp=droq"] + SMALL)
    agent = droq.build_agent_state(OBS, ACT, cfg, None)
    converted, skipped = convert_droq(params, training=True)
    assert skipped == []
    for name in ("actor", "critics", "target_critics"):
        agent[name].load_state_dict(converted[name])
    state = sac.build_optimizers_and_state(cfg, agent)
    state["action_scale"], state["action_bias"] = torch.from_numpy(scale), torch.from_numpy(bias)
    program = droq.build_train_fn(cfg, ACT, -float(ACT))
    data = {k: torch.from_numpy(v) for k, v in critic_batch.items()}
    data["actor_observations"] = torch.from_numpy(actor_obs)
    metrics = program(state, data, noise, sac.ema_gates(True, float(cfg.algo.tau)))
    j_metrics = np.asarray(j_metrics)
    np.testing.assert_allclose(metrics.numpy()[[0, 2]], j_metrics[[0, 2]], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(metrics.numpy()[1], j_metrics[1], rtol=0, atol=1e-2)

    after, _ = convert_droq(new_params, training=True)
    for name in ("critics", "target_critics"):
        for pname, p in state[name].named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), after[name][pname].numpy(), rtol=0, atol=2e-5,
                                       err_msg=f"{name}.{pname}")
    grads, _ = convert_droq({**new_params, "actor": _first_moments(new_opts["actor"])}, training=True)
    lr = float(cfg.algo.actor.optimizer.lr)
    for pname, p in state["actor"].named_parameters():
        want = grads["actor"][pname].numpy() / 0.1
        tol = np.where(np.abs(want) <= 1e-5, 2 * lr, 2e-6)
        diff = np.abs(p.detach().numpy() - after["actor"][pname].numpy())
        assert (diff <= tol).all(), f"actor.{pname}: {diff.max()}"
    np.testing.assert_allclose(state["log_alpha"].detach().numpy(), new_params["log_alpha"], rtol=0, atol=2e-6)
    assert int(state["opt"]["qf"].state[next(state["critics"].parameters())]["step"]) == G

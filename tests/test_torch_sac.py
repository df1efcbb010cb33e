"""The port's SAC against the JAX package on the CPU.

Both sides get the same weights (the JAX ``build_agent_state``'s, carried
across by ``convert_sac(..., training=True)``), the same numpy batch from a
seed and the same noise: the JAX step draws its standard normals from its
key inside the jitted program, and this file re-derives them with JAX's own
key schedule (``split`` of the burst key into the G step keys; each step's
``split`` into the actor's and the critic's key; ``jax.random.normal`` of
each at ``[B, A]``). Seeds are never matched across the frameworks.

Tolerances (float32 on the CPU; XLA and PyTorch sum in other orders):

- the actor's outputs, the squashed sample and its log-prob, the greedy
  action and the ensemble's values: atol 1e-5 (log-probs 1e-4);
- every loss of a step: rtol 1e-4, atol 1e-6;
- gradients, read from the optimizers' first moments after the step
  (``(1 − β1)·g`` after one Adam step): rtol 1e-3, atol 1e-5;
- updated parameters, target critics and ``log_alpha``: atol 2e-6, and
  ``2·lr`` where the JAX gradient lies within the gradient atol of zero
  (Adam's first step turns a rounding-sized gradient into ±lr);
- a two-step burst: see :func:`test_burst_matches_jax`.
"""

from __future__ import annotations

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.sac import agent as jax_agent
from sheeprl_tpu.algos.sac import sac as jax_sac
from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.config.instantiate import instantiate as jax_instantiate
from sheeprl_tpu.fabric import Fabric
from sheeprl_tpu_torch.algos.sac import sac
from sheeprl_tpu_torch.algos.sac.agent import (
    CriticEnsemble,
    SACActor,
    action_bounds,
    build_agent_state,
    greedy_action,
    squash_sample,
)
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.convert import convert_critic_ensemble, convert_sac, convert_sac_actor
from test_torch_dreamer_v2_train import _first_moments

OBS, ACT, HIDDEN, N, B = 5, 2, 16, 2, 8
SMALL = [f"algo.hidden_size={HIDDEN}", f"per_rank_batch_size={B}", "metric.log_level=0"]
LOW, HIGH = np.array([-2.0, -1.0], np.float32), np.array([2.0, 3.0], np.float32)
OUT_TOL = dict(rtol=0, atol=1e-5)
METRIC_TOL = dict(rtol=1e-4, atol=1e-6)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
PARAM_ATOL = 2e-6


def jax_fabric() -> Fabric:
    """The JAX package's Fabric: made before any key of a step (it sets the key implementation)."""
    return Fabric(devices=1, accelerator="cpu")


@pytest.fixture(autouse=True, scope="module")
def restore_prng_impl():
    """The JAX Fabric switches JAX's default key implementation for the
    whole process (to ``rbg``): put it back after the module, so that a
    later file on the same worker draws the keys it expects (a
    ``PRNGKey(1)`` of ``tests/test_envs/test_rollout.py`` otherwise starts
    another Pendulum trajectory)."""
    saved = jax.config.jax_default_prng_impl
    yield
    jax.config.update("jax_default_prng_impl", saved)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def jax_state(key=3, obs_dim=OBS):
    actor = jax_agent.SACActor(action_dim=ACT, hidden_size=HIDDEN)
    critic = jax_agent.SACCritic(hidden_size=HIDDEN, num_critics=1)
    state = jax_agent.build_agent_state(actor, critic, jax.random.PRNGKey(key), N, obs_dim, ACT, 1.0)
    return actor, critic, jax.device_get(state)


def transition_batch(seed: int, g: int = 1, obs_dim: int = OBS):
    rng = np.random.RandomState(seed)
    dones = (rng.uniform(size=(g, B, 1)) < 0.25).astype(np.float32)
    return {
        "observations": rng.randn(g, B, obs_dim).astype(np.float32),
        "actions": rng.uniform(LOW, HIGH, (g, B, ACT)).astype(np.float32),
        "rewards": rng.randn(g, B, 1).astype(np.float32),
        "dones": dones,
        "next_observations": rng.randn(g, B, obs_dim).astype(np.float32),
    }


def sac_noise(key, g: int):
    """The G steps' ``{"next", "actor"}`` normals, as ``local_train`` and ``one_step`` split ``key``."""
    out = []
    for k in jax.random.split(key, g):
        a_key, c_key = jax.random.split(k)
        out.append({"next": _t(jax.random.normal(c_key, (B, ACT))), "actor": _t(jax.random.normal(a_key, (B, ACT)))})
    return out


def torch_state(cfg, params, modules=("actor", "critics", "target_critics")):
    """The port's SAC state from the JAX params (``convert_sac``, training)."""
    agent = build_agent_state(OBS, ACT, HIDDEN, HIDDEN, N, 1.0, None)
    converted, skipped = convert_sac(params, training=True)
    assert skipped == []
    for name in modules:
        agent[name].load_state_dict(converted[name])
    with torch.no_grad():
        agent["log_alpha"].copy_(converted["log_alpha"])
    state = sac.build_optimizers_and_state(cfg, agent)
    scale, bias = action_bounds(gym.spaces.Box(LOW, HIGH))
    state["action_scale"], state["action_bias"] = torch.from_numpy(scale), torch.from_numpy(bias)
    return state


def check_params(cfg, state, new_params, new_opts, names_to_opt, lr_of, converter=convert_sac):
    """Every trained tree's parameters and first moments against JAX's."""
    after, _ = converter(new_params, training=True)
    for name, opt_name in names_to_opt.items():
        if opt_name is None:  # a target: its parameters only
            for pname, p in state[name].named_parameters():
                np.testing.assert_allclose(p.detach().numpy(), after[name][pname].numpy(), rtol=0, atol=PARAM_ATOL,
                                           err_msg=f"{name}.{pname}")
            continue
        grads, _ = converter({**new_params, name: _first_moments(new_opts[opt_name])}, training=True)
        lr = lr_of(opt_name)
        for pname, p in state[name].named_parameters():
            want = grads[name][pname].numpy() / 0.1
            got = state["opt"][opt_name].state[p]["exp_avg"].numpy() / 0.1
            np.testing.assert_allclose(got, want, **GRAD_TOL, err_msg=f"{name}.{pname} gradient")
            tol = np.where(np.abs(want) <= GRAD_TOL["atol"], 2 * lr, PARAM_ATOL)
            diff = np.abs(p.detach().numpy() - after[name][pname].numpy())
            assert (diff <= tol).all(), f"{name}.{pname}: {diff.max()}"


def test_actor_sample_and_greedy_match_jax():
    actor, _critic, params = jax_state()
    obs = np.random.RandomState(0).randn(B, OBS).astype(np.float32)
    j_mean, j_std = actor.apply({"params": params["actor"]}, obs)
    port = SACActor(OBS, ACT, HIDDEN)
    port.load_state_dict(convert_sac_actor(params["actor"]))
    mean, std = port(torch.from_numpy(obs))
    np.testing.assert_allclose(mean.detach().numpy(), j_mean, **OUT_TOL)
    np.testing.assert_allclose(std.detach().numpy(), j_std, **OUT_TOL)
    scale, bias = action_bounds(gym.spaces.Box(LOW, HIGH))
    key = jax.random.PRNGKey(5)
    j_act, j_logp = jax_agent.squash_sample(j_mean, j_std, key, jnp.asarray(scale), jnp.asarray(bias))
    act, logp = squash_sample(mean, std, _t(jax.random.normal(key, (B, ACT))), torch.from_numpy(scale),
                              torch.from_numpy(bias))
    np.testing.assert_allclose(act.detach().numpy(), j_act, **OUT_TOL)
    np.testing.assert_allclose(logp.detach().numpy(), j_logp, rtol=0, atol=1e-4)
    assert logp.shape == (B, 1)
    greedy = greedy_action(mean, torch.from_numpy(scale), torch.from_numpy(bias))
    np.testing.assert_allclose(greedy.detach().numpy(), jax_agent.greedy_action(j_mean, scale, bias), **OUT_TOL)


def test_critic_ensemble_matches_jax():
    _actor, critic, params = jax_state()
    rng = np.random.RandomState(1)
    obs, act = rng.randn(B, OBS).astype(np.float32), rng.randn(B, ACT).astype(np.float32)
    ensemble = CriticEnsemble(N, OBS + ACT, (HIDDEN, HIDDEN))
    ensemble.load_state_dict(convert_critic_ensemble(params["critics"]))
    assert ensemble.blocks[0].linear.weight.shape == (N, OBS + ACT, HIDDEN)  # the stacked layout, kept
    q = ensemble(torch.from_numpy(obs), torch.from_numpy(act))
    want = jax_agent.ensemble_q(critic, params["critics"], obs, act)
    assert q.shape == (B, N)
    np.testing.assert_allclose(q.detach().numpy(), want, **OUT_TOL)


def test_action_bounds_match_jax():
    space = gym.spaces.Box(np.array([-1.0, -np.inf, 0.0], np.float32), np.array([3.0, 1.0, np.inf], np.float32))
    for got, want in zip(action_bounds(space), jax_agent.action_bounds(space)):
        np.testing.assert_array_equal(got, want)


def _jax_train(cfg_overrides, params, g: int, key, batch, do_ema: bool):
    jcfg = jax_compose(overrides=["exp=sac"] + cfg_overrides)
    actor = jax_agent.SACActor(action_dim=ACT, hidden_size=HIDDEN)
    critic = jax_agent.SACCritic(hidden_size=HIDDEN, num_critics=1)
    txs = {k: jax_instantiate(jcfg.algo[n].optimizer) for k, n in (("actor", "actor"), ("qf", "critic"),
                                                                   ("alpha", "alpha"))}
    opts = {"actor": txs["actor"].init(params["actor"]), "qf": txs["qf"].init(params["critics"]),
            "alpha": txs["alpha"].init(params["log_alpha"])}
    scale, bias = action_bounds(gym.spaces.Box(LOW, HIGH))
    train = jax_sac.build_train_fn(actor, critic, txs["actor"], txs["qf"], txs["alpha"], jcfg,
                                   jax_fabric(), scale, bias, -float(ACT), donate=False)
    state, opts, metrics = train(jax.tree_util.tree_map(jnp.asarray, params), opts,
                                 {k: jnp.asarray(v) for k, v in batch.items()}, key, jnp.bool_(do_ema))
    return jax.device_get(state), jax.device_get(opts), np.asarray(metrics)


@pytest.mark.parametrize("do_ema", [True, False])
def test_one_step_matches_jax(do_ema):
    """One gradient step (critic, target EMA on or off, actor on the fresh
    critics, alpha) of both packages."""
    jax_fabric()
    _actor, _critic, params = jax_state()
    overrides = SMALL + ["algo.alpha.alpha=0.5"]
    params["log_alpha"] = np.log(np.asarray([0.5], np.float32))
    batch = transition_batch(7)
    key = jax.random.PRNGKey(11)
    new_params, new_opts, j_metrics = _jax_train(overrides, params, 1, key, batch, do_ema)
    cfg = compose(overrides=["exp=sac"] + overrides)
    state = torch_state(cfg, params)
    program = sac.build_train_fn(cfg, ACT, -float(ACT))
    metrics = program(state, {k: torch.from_numpy(v[0]) for k, v in batch.items()}, sac_noise(key, 1)[0],
                      sac.ema_gates(do_ema, float(cfg.algo.tau)))
    np.testing.assert_allclose(metrics.numpy(), j_metrics, **METRIC_TOL)
    lr_of = lambda name: float(cfg.algo[{"qf": "critic"}.get(name, name)].optimizer.lr)  # noqa: E731
    check_params(cfg, state, new_params, new_opts, {"actor": "actor", "critics": "qf", "target_critics": None},
                 lr_of)
    np.testing.assert_allclose(state["log_alpha"].detach().numpy(), new_params["log_alpha"], rtol=0, atol=PARAM_ATOL)
    moved = not np.allclose(new_params["target_critics"]["MLP_0"]["Dense_0"]["kernel"],
                            params["target_critics"]["MLP_0"]["Dense_0"]["kernel"])
    assert moved == do_ema


def test_burst_matches_jax():
    """A burst of two gradient steps through ``StepProgram.burst`` (the path
    of the catch-up burst and of G > 1): the burst's mean losses and the
    state after both steps. The second step reads the first one's float32
    differences: the parameters agree within 2e-5. The losses hold at rtol
    1e-3, atol 5e-3: after the first step the actor's std reaches 6.5, a
    sample at |x| ≈ 6.8 has ``1 − tanh²`` ≈ 5e-6, and one float32 ulp of
    tanh there moves its log-prob by ≈ 0.02 (the policy loss of this batch
    moves by 2.8e-3 between the frameworks, its value loss by 1e-7)."""
    jax_fabric()
    _actor, _critic, params = jax_state(key=4)
    batch = transition_batch(8, g=2)
    key = jax.random.PRNGKey(12)
    new_params, _new_opts, j_metrics = _jax_train(SMALL, params, 2, key, batch, True)
    cfg = compose(overrides=["exp=sac"] + SMALL)
    state = torch_state(cfg, params)
    program = sac.build_train_fn(cfg, ACT, -float(ACT))
    metrics = program.burst(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                            sac.ema_gates(True, float(cfg.algo.tau)), noise=sac_noise(key, 2))
    assert program.static.step.eager_calls == 2
    np.testing.assert_allclose(metrics.numpy(), j_metrics, rtol=1e-3, atol=5e-3)
    after, _ = convert_sac(new_params, training=True)
    for name in ("actor", "critics", "target_critics"):
        for pname, p in state[name].named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), after[name][pname].numpy(), rtol=0, atol=2e-5,
                                       err_msg=f"{name}.{pname}")
    np.testing.assert_allclose(state["log_alpha"].detach().numpy(), new_params["log_alpha"], rtol=0, atol=PARAM_ATOL)

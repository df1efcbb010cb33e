"""The port's PPO against the JAX package on the CPU.

Both sides get the same weights (the JAX agent's flax init, carried across
by ``convert_ppo``), the same numpy inputs from a seed and the same noise:
the JAX samplers draw theirs from a key, and this file re-derives it with
JAX's own schedule (``gumbel(fold_in(key, i), logits.shape)`` per discrete
head, ``normal(key, mean.shape)`` for a Box); the JAX update draws its
permutations from its key (``split(fold_in(key, 0), epochs)``, then
``permutation`` of each), and the port's update is given those.

Tolerances (float32 on the CPU; XLA and PyTorch sum in other orders):

- the agent's heads and values, log-probs, entropies, the losses: atol 1e-5;
- GAE: atol 1e-6; ``normalize_tensor``: atol 1e-6 (and it is the
  population std: ``torch.std``'s default differs by more than 1e-3 here);
- one whole update (2 epochs × 2 minibatches): the mean losses within 1e-5
  relative; Adam's moments within 1e-5 relative (L2 over each tensor), the
  second one in the gradient's units, ``sqrt(v)`` (``v`` squares the
  gradient and doubles its relative differences); parameters within 1e-5
  relative (L2 over each tensor), and within ``2·lr`` a step for an element
  whose JAX first moment lies within 1e-7 of zero (Adam's step turns a
  rounding-sized gradient into ±lr), which the L2 leaves out.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.ppo import agent as jax_agent
from sheeprl_tpu.algos.ppo import loss as jax_loss
from sheeprl_tpu.algos.ppo import ppo as jax_ppo
from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.config.instantiate import instantiate as jax_instantiate
from sheeprl_tpu.fabric import Fabric
from sheeprl_tpu.utils.utils import gae as jax_gae
from sheeprl_tpu.utils.utils import normalize_tensor as jax_normalize_tensor
from sheeprl_tpu_torch.algos.ppo import loss as port_loss
from sheeprl_tpu_torch.algos.ppo.agent import PPOAgent, evaluate_actions, greedy_actions, sample_actions
from sheeprl_tpu_torch.algos.ppo.ppo import UpdateProgram, build_optimizer, ppo_loss, select_rows
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.convert import convert_optax_state, convert_ppo
from sheeprl_tpu_torch.utils.utils import gae, normalize_tensor

OUT_TOL = dict(rtol=0, atol=1e-5)
B, STATE, FEAT, UNITS = 16, 5, 16, 16
# (cnn keys, mlp keys) and action spaces, as test_algos.py's PPO runs parametrize them
OBS_KINDS = {"mlp": ((), ("state",)), "pixels_and_mlp": (("rgb",), ("state",))}
ACTIONS = {"discrete": ((3,), False), "multidiscrete": ((3, 2), False), "continuous": ((2,), True)}


@pytest.fixture(autouse=True, scope="module")
def restore_prng_impl():
    """The JAX Fabric switches JAX's default key implementation for the
    whole process (to ``rbg``): put it back after the module, so that a
    later file on the same worker draws the keys it expects."""
    saved = jax.config.jax_default_prng_impl
    yield
    jax.config.update("jax_default_prng_impl", saved)


def test_restore_prng_impl_puts_the_default_key_back():
    """The fault and its repair: after a JAX ``Fabric``, ``PRNGKey(1)`` is
    another key (the Pendulum test of ``tests/test_envs/test_rollout.py``
    then starts another trajectory); once the module fixture has run, it is
    the default key again."""
    saved = jax.config.jax_default_prng_impl
    try:
        jax.config.update("jax_default_prng_impl", "threefry2x32")
        default = np.asarray(jax.random.key_data(jax.random.PRNGKey(1)))
        fixture = restore_prng_impl.__wrapped__()
        next(fixture)
        Fabric(devices=1, accelerator="cpu")
        switched = np.asarray(jax.random.key_data(jax.random.PRNGKey(1)))
        assert switched.shape != default.shape or not np.array_equal(switched, default)
        with pytest.raises(StopIteration):
            next(fixture)
        np.testing.assert_array_equal(np.asarray(jax.random.key_data(jax.random.PRNGKey(1))), default)
    finally:
        jax.config.update("jax_default_prng_impl", saved)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def observations(seed: int, kind: str, n: int = B):
    rng = np.random.RandomState(seed)
    obs = {"state": rng.randn(n, STATE).astype(np.float32)}
    if "rgb" in OBS_KINDS[kind][0]:
        obs["rgb"] = rng.randint(0, 256, (n, 3, 64, 64)).astype(np.uint8)
    return obs


def normalized(obs):
    return {k: (v.astype(np.float32) / 255.0 - 0.5) if k == "rgb" else v for k, v in obs.items()}


def agents(kind: str, action: str, key: int = 0):
    """The JAX agent and its params, and the port's agent with them."""
    cnn_keys, mlp_keys = OBS_KINDS[kind]
    actions_dim, is_continuous = ACTIONS[action]
    widths = dict(cnn_features_dim=FEAT, mlp_features_dim=FEAT, encoder_dense_units=UNITS, actor_dense_units=UNITS,
                  critic_dense_units=UNITS)
    j = jax_agent.PPOAgent(actions_dim=actions_dim, is_continuous=is_continuous, cnn_keys=cnn_keys,
                           mlp_keys=mlp_keys, screen_size=64, **widths)
    dummy = {k: jnp.asarray(v, jnp.float32) for k, v in normalized(observations(0, kind, 1)).items()}
    params = jax.device_get(j.init(jax.random.PRNGKey(key), dummy)["params"])
    port = PPOAgent(actions_dim, is_continuous, cnn_keys, mlp_keys, 3 if cnn_keys else 0, STATE, **widths)
    port.load_state_dict(convert_ppo(params))
    return j, params, port


@pytest.mark.parametrize("action", ACTIONS)
@pytest.mark.parametrize("kind", OBS_KINDS)
def test_agent_forward_and_heads_match_jax(kind, action):
    """The forward (heads and values), ``sample_actions`` at the JAX
    function's own Gumbel or normal noise, ``evaluate_actions`` of the
    sampled actions and ``greedy_actions``."""
    j, params, port = agents(kind, action)
    actions_dim, is_continuous = ACTIONS[action]
    obs = normalized(observations(1, kind))
    j_pre, j_values = j.apply({"params": params}, obs)
    pre, values = port({k: torch.from_numpy(v) for k, v in obs.items()})
    for a, b in zip(pre, j_pre):
        np.testing.assert_allclose(a.detach().numpy(), b, **OUT_TOL)
    np.testing.assert_allclose(values.detach().numpy(), j_values, **OUT_TOL)

    key = jax.random.PRNGKey(7)
    j_stored, j_real, j_logp = jax_agent.sample_actions(j_pre, is_continuous, key)
    if is_continuous:
        noise = [_t(jax.random.normal(key, (B, sum(actions_dim))))]
    else:
        noise = [_t(jax.random.gumbel(jax.random.fold_in(key, i), (B, d))) for i, d in enumerate(actions_dim)]
    stored, real, logp = sample_actions(pre, is_continuous, noise)
    np.testing.assert_allclose(stored.detach().numpy(), j_stored, **OUT_TOL)
    np.testing.assert_array_equal(real.detach().numpy(), np.asarray(j_real)) if not is_continuous else \
        np.testing.assert_allclose(real.detach().numpy(), j_real, **OUT_TOL)
    np.testing.assert_allclose(logp.detach().numpy(), j_logp, **OUT_TOL)

    j_lp, j_ent = jax_agent.evaluate_actions(j_pre, j_stored, actions_dim, is_continuous)
    lp, ent = evaluate_actions(pre, _t(j_stored), actions_dim, is_continuous)
    np.testing.assert_allclose(lp.detach().numpy(), j_lp, **OUT_TOL)
    np.testing.assert_allclose(ent.detach().numpy(), j_ent, **OUT_TOL)
    greedy = greedy_actions(pre, is_continuous).detach().numpy()
    want = np.asarray(jax_agent.greedy_actions(j_pre, is_continuous))
    np.testing.assert_allclose(greedy, want, **OUT_TOL) if is_continuous else np.testing.assert_array_equal(greedy,
                                                                                                         want)


@pytest.mark.parametrize("clip_vloss", [False, True])
@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_losses_match_jax(clip_vloss, reduction):
    rng = np.random.RandomState(3)
    new_lp, lp, adv, new_v, v, ret, ent = (rng.randn(B, 1).astype(np.float32) * 0.3 for _ in range(7))
    for got, want in (
        (port_loss.policy_loss(_t(new_lp), _t(lp), _t(adv), torch.tensor(0.2), reduction),
         jax_loss.policy_loss(new_lp, lp, adv, jnp.float32(0.2), reduction)),
        (port_loss.value_loss(_t(new_v), _t(v), _t(ret), torch.tensor(0.2), clip_vloss, reduction),
         jax_loss.value_loss(new_v, v, ret, jnp.float32(0.2), clip_vloss, reduction)),
        (port_loss.entropy_loss(_t(ent), reduction), jax_loss.entropy_loss(ent, reduction)),
    ):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)


@pytest.mark.parametrize("gae_lambda", [0.95, 1.0])
def test_gae_and_normalize_tensor_match_jax(gae_lambda):
    rng = np.random.RandomState(4)
    T, n = 12, 3
    rewards = rng.randn(T, n, 1).astype(np.float32)
    values = rng.randn(T, n, 1).astype(np.float32)
    dones = (rng.uniform(size=(T, n, 1)) < 0.2).astype(np.float32)
    next_value = rng.randn(n, 1).astype(np.float32)
    j_ret, j_adv = jax_gae(rewards, values, dones, next_value, 0.99, gae_lambda)
    ret, adv = gae(_t(rewards), _t(values), _t(dones), _t(next_value), 0.99, gae_lambda)
    np.testing.assert_allclose(ret.numpy(), j_ret, rtol=0, atol=1e-6)
    np.testing.assert_allclose(adv.numpy(), j_adv, rtol=0, atol=1e-6)
    x = rng.randn(10, 1).astype(np.float32)
    np.testing.assert_allclose(normalize_tensor(_t(x)).numpy(), jax_normalize_tensor(x), rtol=0, atol=1e-6)
    sample_std = (_t(x) - _t(x).mean()) / (_t(x).std() + 1e-8)  # torch's default: correction=1
    assert np.abs(sample_std.numpy() - np.asarray(jax_normalize_tensor(x))).max() > 1e-3


# ---------------------------------------------------------------------------
# one whole update
# ---------------------------------------------------------------------------

N_LOCAL, EPOCHS, BS = 16, 2, 8


def rollout_batch(seed: int, kind: str, action: str, n: int = N_LOCAL):
    """A flat rollout ``[n, ...]``: observations, stored actions, the rest."""
    rng = np.random.RandomState(seed)
    actions_dim, is_continuous = ACTIONS[action]
    if is_continuous:
        actions = rng.randn(n, sum(actions_dim)).astype(np.float32)
    else:
        actions = np.concatenate([np.eye(d, dtype=np.float32)[rng.randint(0, d, n)] for d in actions_dim], -1)
    return {**observations(seed, kind, n), "actions": actions,
            **{k: (rng.randn(n, 1) * s).astype(np.float32) for k, s in (("logprobs", 0.5), ("values", 1.0),
                                                                        ("returns", 1.0), ("advantages", 1.0))}}


def update_overrides(kind: str, extra=()):
    cnn, mlp = OBS_KINDS[kind]
    return [f"algo.encoder.cnn_features_dim={FEAT}", f"algo.encoder.mlp_features_dim={FEAT}",
            f"algo.dense_units={UNITS}", f"per_rank_batch_size={BS}", f"algo.update_epochs={EPOCHS}",
            f"cnn_keys.encoder=[{','.join(cnn)}]", f"mlp_keys.encoder=[{','.join(mlp)}]", *extra]


def jax_update(exp: str, overrides, j, params, data, key, clip_coef=0.2, ent_coef=0.01, update_fn_builder=None):
    """The JAX update (``build_update_fn``) on a one-device CPU Fabric: its
    new params and optimizer state, its metrics, and its permutations."""
    fabric = Fabric(devices=1, accelerator="cpu")
    jcfg = jax_compose(overrides=[f"exp={exp}"] + overrides)
    tx = jax_instantiate(jcfg.algo.optimizer, max_grad_norm=jcfg.algo.max_grad_norm or None)
    opt_state = tx.init(params)
    build = update_fn_builder or jax_ppo.build_update_fn
    update = build(j, tx, jcfg, fabric, N_LOCAL)
    key = jax.random.PRNGKey(key)
    args = (jax.tree_util.tree_map(jnp.array, params), opt_state, {k: jnp.asarray(v) for k, v in data.items()}, key)
    if exp == "a2c":  # one pass over one permutation, no annealed scalars
        outs = update(*args)
        perms = [np.asarray(jax.random.permutation(jax.random.fold_in(key, 0), N_LOCAL))]
    else:
        outs = update(*args, jnp.float32(clip_coef), jnp.float32(ent_coef))
        perms = [np.asarray(jax.random.permutation(k, N_LOCAL))
                 for k in jax.random.split(jax.random.fold_in(key, 0), int(jcfg.algo.update_epochs))]
    return jax.device_get(outs[0]), jax.device_get(outs[1]), np.asarray(outs[2]), perms


def check_update(port, optimizer, new_params, new_opt, lr: float, n_steps: int, converter=convert_ppo):
    """The port's parameters and Adam moments after the update against JAX's."""
    names = [n for n, _ in port.named_parameters()]
    want_state = convert_optax_state(new_opt, converter, names)["state"]
    after = converter(new_params)
    for i, (name, p) in enumerate(port.named_parameters()):
        state = optimizer.state[p]
        for k, unit in (("exp_avg", lambda m: m), ("exp_avg_sq", np.sqrt)):
            want = unit(want_state[i][k].numpy().astype(np.float64))
            dist = np.linalg.norm(unit(state[k].numpy().astype(np.float64)) - want) / max(np.linalg.norm(want), 1e-30)
            assert dist <= 1e-5, f"{name} {k}: relative L2 distance {dist}"
        assert float(state["step"]) == float(want_state[i]["step"]) == n_steps
        want = after[name].numpy().astype(np.float64)
        near_zero = np.abs(want_state[i]["exp_avg"].numpy()) <= 1e-7
        diff = np.abs(p.detach().numpy() - want)
        assert (diff[near_zero] <= 2 * lr * n_steps).all(), f"{name}: {diff[near_zero].max()}"
        dist = np.linalg.norm(diff[~near_zero]) / max(np.linalg.norm(want[~near_zero]), 1e-30)
        assert dist <= 1e-5, f"{name}: relative L2 distance {dist}"


@pytest.mark.parametrize("kind,action,extra", [
    ("mlp", "discrete", ()),
    ("mlp", "continuous", ("algo.normalize_advantages=True", "algo.clip_vloss=True", "algo.max_grad_norm=0.5")),
    ("pixels_and_mlp", "multidiscrete", ()),
])
def test_update_matches_jax(kind, action, extra):
    """One whole PPO update, 2 epochs × 2 minibatches, at the JAX update's
    own permutations: the mean losses, then every parameter and Adam moment."""
    j, params, port = agents(kind, action, key=2)
    overrides = update_overrides(kind, extra)
    data = rollout_batch(5, kind, action)
    new_params, new_opt, j_metrics, perms = jax_update("ppo", overrides, j, params, data, key=9)
    cfg = compose(overrides=["exp=ppo"] + overrides)
    actions_dim, is_continuous = ACTIONS[action]
    cnn, mlp = OBS_KINDS[kind]
    optimizer = build_optimizer(cfg, port)
    program = UpdateProgram(ppo_loss(cfg, list(cnn), list(mlp) + list(cnn), actions_dim, is_continuous), select_rows,
                            port, optimizer, max_grad_norm=float(cfg.algo.max_grad_norm or 0.0), epochs=EPOCHS,
                            n_samples=N_LOCAL, batch_size=BS, n_metrics=3, n_scalars=2, generator=None, device="cpu")
    metrics = program.update(data, [0.2, 0.01], perms=perms)
    np.testing.assert_allclose(metrics.numpy(), j_metrics, rtol=1e-5, atol=1e-7)
    check_update(port, optimizer, new_params, new_opt, float(cfg.algo.optimizer.lr), EPOCHS * (N_LOCAL // BS))


# ---------------------------------------------------------------------------
# the optimizers the on-policy presets configure
# ---------------------------------------------------------------------------

OPTIMIZERS = {
    "Adam": dict(lr=1e-2, eps=1e-5, weight_decay=0.0),
    "AdamW": dict(lr=1e-2, eps=1e-5, weight_decay=0.1),
    "SGD": dict(lr=1e-2, momentum=0.0, weight_decay=0.0),
    "SGD-momentum-decay": dict(lr=1e-2, momentum=0.9, weight_decay=0.1),
    "SGD-nesterov": dict(lr=1e-2, momentum=0.9, nesterov=True),
}


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizers_and_set_lr_match_the_jax_factories(name):
    """Four steps of the JAX factory (``optax.inject_hyperparams``, behind
    ``clip_by_global_norm`` at 1.0) and of the port's optimizer (its
    learning rate a device scalar), the rate set between steps by each package's
    ``set_lr`` (the annealing's schedule); the first step's gradients far
    above the clip. Parameters within rtol 1e-5, atol 1e-7; the converted
    optax state equals the port's. With SGD's weight decay the JAX
    ``set_lr`` does not reach the nested rate: that case keeps its rate."""
    import optax

    from sheeprl_tpu.utils import optim as jax_optim
    from sheeprl_tpu_torch.utils import optim as port_optim

    kwargs = OPTIMIZERS[name]
    cls = name.split("-")[0]
    rng = np.random.RandomState(0)
    init = {"w": rng.randn(5, 3).astype(np.float32), "b": rng.randn(3).astype(np.float32)}
    tx = getattr(jax_optim, cls)(max_grad_norm=1.0, **kwargs)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = tx.init(jparams)
    module = torch.nn.Module()
    for k in ("b", "w"):  # named_parameters order: b, then w
        module.register_parameter(k, torch.nn.Parameter(torch.from_numpy(init[k].copy())))
    opt = getattr(port_optim, cls)(module.parameters(), **kwargs)
    assert isinstance(opt.lr, torch.Tensor)
    # the JAX set_lr reaches an inject_hyperparams state one chain level deep: SGD's weight decay nests it
    # (chain(clip, chain(add_decayed_weights, inject))), where it keeps the rate it was built with
    anneal = not (cls == "SGD" and kwargs.get("weight_decay"))
    for step in range(4):
        lr = 1e-2 * (1.0 - step / 4) if anneal else 1e-2
        jstate = jax_optim.set_lr(jstate, lr)
        port_optim.set_lr(opt, lr)
        grads = {k: ((10.0 if step == 0 else 0.05) * rng.randn(*v.shape)).astype(np.float32) for k, v in init.items()}
        updates, jstate = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in module.named_parameters():
            p.grad = torch.from_numpy(grads[k].copy())
        clip_by_global_norm_ = port_optim.clip_by_global_norm_
        clip_by_global_norm_([p.grad for p in module.parameters()], 1.0)
        opt.step()
        for k, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=1e-5, atol=1e-7)
    converted = convert_optax_state(jax.device_get(jstate), lambda t: {k: _t(v) for k, v in t.items()}, ["b", "w"])
    assert converted["lr"] == pytest.approx(float(opt.lr))
    for i, p in enumerate(module.parameters()):
        for k, v in converted["state"].get(i, {}).items():
            np.testing.assert_allclose(np.asarray(opt.state[p][k]), v.numpy(), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("exp,target", [("ppo", "Adam"), ("ppo_recurrent", "AdamW"), ("ppo", "SGD")])
def test_the_presets_optimizers_instantiate(exp, target):
    """``utils.optim.AdamW`` (PPO-recurrent's preset) and ``SGD``
    (``configs/optim/sgd.yaml``, which carries ``dampening: 0``) instantiate
    from the config tree."""
    import os

    import sheeprl_tpu_torch.configs as configs
    from sheeprl_tpu_torch.config.engine import yaml_load
    from sheeprl_tpu_torch.utils import optim as port_optim

    cfg = compose(overrides=[f"exp={exp}"])
    if target == "SGD":
        with open(os.path.join(os.path.dirname(configs.__file__), "optim", "sgd.yaml")) as f:
            cfg.algo.optimizer = yaml_load(f.read())
    _j, _params, port = agents("mlp", "discrete")
    opt = build_optimizer(cfg, port)
    assert type(opt) is getattr(port_optim, target)
    assert float(opt.lr) == pytest.approx(float(cfg.algo.optimizer.lr))

"""DreamerV3 on ``exp=dreamer_v3 env=minedojo`` in the port against the JAX
package, over the MineDojo stand-in (``tests/sim_stubs.py``; the fixture of
``test_torch_envs_sims.py``), at a tiny width on the CPU.

- The CLIs: a dry run of each (one acting step of two envs, then one
  gradient step, no test episode: the JAX loop passes the masks to its
  acting steps only). No env restarted and the stand-in flagged none of the
  actions as forbidden by the masks it handed out; its observations do not
  depend on the actions, so both buffers hold the same rows but the
  actions, which come from two PRNG streams (the player's parity at
  injected noise is ``test_torch_dreamer_v3_minecraft.py``'s); each stored
  action is one one-hot a head. The port's acting step carries the masks as
  inputs (one static buffer a key).
- The training step on MineDojo's keys (the frame; the inventory,
  equipment and life-stats vectors the wrapper makes) and its three action
  heads: one gradient step of each side from the same weights (the JAX
  build's, with the reward and critic heads and the target critic moved off
  their initial values), on a batch the port's env pipeline rolled over the
  stand-in, with the JAX step's noise re-derived from its key. Tolerances
  as ``test_torch_dreamer_v3_train.py`` states them: every loss and metric
  rtol 1e-4, atol 1e-6; each gradient (the optimizers' first moments) rtol
  1e-3, atol 2e-5 of its largest magnitude; the updated parameters and the
  target critic atol 1.6e-6 (2% of the actor's learning rate)."""

import glob
import warnings

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import cpu_threads  # noqa: F401  (one CPU thread a process: see cpu_threads.py)
import pytest
import sim_stubs
import torch
from jax_cli_switches import run_jax_cli
from jax_jit_build import jit_build
from test_torch_dreamer_v3_train import _check_first_moments, _check_metrics, _check_params
from test_torch_envs_sims import sims  # noqa: F401  (the stand-in simulators fixture)

from sheeprl_tpu.algos.dreamer_v3 import agent as jax_agent
from sheeprl_tpu.algos.dreamer_v3 import dreamer_v3 as jax_dv3
from sheeprl_tpu.ckpt import read_checkpoint as jax_read_checkpoint
from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.fabric import Fabric
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.dreamer_v3 import agent as port_agent
from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import build_optimizers_and_state, build_train_fn
from sheeprl_tpu_torch.ckpt import read_checkpoint
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.convert import convert_dreamer_v3
from sheeprl_tpu_torch.utils.env import build_env

MASK_KEYS = ("mask_action_type", "mask_craft_smelt", "mask_equip_place", "mask_destroy")
HEADS = (19, len(sim_stubs.MINEDOJO_CRAFT_SMELT), len(sim_stubs.MC_ITEMS))
TINY_CLI = [
    "algo.dense_units=8", "algo.mlp_layers=1", "algo.world_model.encoder.cnn_channels_multiplier=2",
    "algo.world_model.recurrent_model.recurrent_state_size=8", "algo.world_model.transition_model.hidden_size=8",
    "algo.world_model.representation_model.hidden_size=8", "algo.world_model.stochastic_size=4",
    "algo.world_model.discrete_size=4", "algo.horizon=3", "per_rank_batch_size=2", "fabric.accelerator=cpu",
    "env.sync_env=True", "env.capture_video=False", "metric.log_level=0", "buffer.memmap=False",
    "buffer.checkpoint=True",
]
# the training step's batch and widths
T, B, HORIZON, S, D = 4, 2, 3, 4, 4
MLP = ["inventory", "inventory_max", "inventory_delta", "equipment", "life_stats"]
SMALL = [
    "algo.dense_units=16", "algo.mlp_layers=2", "algo.world_model.encoder.cnn_channels_multiplier=2",
    "algo.world_model.recurrent_model.recurrent_state_size=32", f"algo.world_model.stochastic_size={S}",
    f"algo.world_model.discrete_size={D}", "algo.world_model.transition_model.hidden_size=16",
    "algo.world_model.representation_model.hidden_size=16", f"algo.horizon={HORIZON}", f"per_rank_batch_size={B}",
    f"per_rank_sequence_length={T}", "cnn_keys.encoder=[rgb]", f"mlp_keys.encoder=[{','.join(MLP)}]",
    "env.capture_video=False", "metric.log_level=0",
]


@pytest.fixture(autouse=True, scope="module")
def restore_prng_impl():
    """The JAX CLI's Fabric switches JAX's key implementation for the process: put it back."""
    saved = jax.config.jax_default_prng_impl
    yield
    jax.config.update("jax_default_prng_impl", saved)


def _args(root, name):
    return ["exp=dreamer_v3", "env=minedojo", "dry_run=True", "per_rank_sequence_length=1", "env.num_envs=2",
            "algo.run_test=False", "algo.actor.expl_amount=0.5", "mlp_keys.encoder=[inventory,equipment]",
            f"root_dir={root}", f"run_name={name}"] + TINY_CLI


def _run(run, args):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        result = run(args)
    assert not [w for w in caught if "Restarting env" in str(w.message)]
    return result


def test_one_acting_and_training_step_of_both_clis_on_minedojo(sims, tmp_path):
    made, built = [], []
    make, init = sims["minedojo"].make, port_agent.ExplorationStep.__init__

    def recording_make(*args, **kwargs):
        env = make(*args, **kwargs)
        made.append(env)
        return env

    def recording_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        built.append(self)

    sims["minedojo"].make = recording_make
    _run(run_jax_cli, _args(tmp_path, "jax"))
    assert sum(len(env.received) for env in made) == 2  # one acting step of two envs
    assert all(env.invalid == [] for env in made)  # the masked acting step: every action valid under its masks
    (jax_ckpt,) = glob.glob(str(tmp_path / "jax" / "version_0" / "checkpoint" / "ckpt_*"))
    made.clear()
    port_agent.ExplorationStep.__init__ = recording_init
    try:
        result = _run(cli.run, _args(tmp_path, "port"))
    finally:
        port_agent.ExplorationStep.__init__ = init
    assert sum(len(env.received) for env in made) == 2
    assert all(env.invalid == [] for env in made)
    assert (result["player_steps"], result["gradient_steps"], result["random_steps"]) == (1, 1, 0)

    (step,) = built
    assert set(step.masks) == set(MASK_KEYS)
    assert step.masks["mask_action_type"].shape == (2, 19) and step.masks["mask_action_type"].dtype == torch.bool
    assert step.masks["mask_action_type"][:, :12].all()  # movement and camera are always valid

    ours = read_checkpoint(result["checkpoint"], with_rb=True)["rb"]["buffers"]
    theirs = jax_read_checkpoint(jax_ckpt)["rb"]["buffers"]
    assert len(ours) == len(theirs) == 2
    for mine, jax_buffer in zip(ours, theirs):
        assert mine["buffer"].keys() == jax_buffer["buffer"].keys()
        assert (int(mine["pos"]), bool(mine["full"])) == (int(jax_buffer["pos"]), bool(jax_buffer["full"]))
        rows = int(mine["pos"])  # the rows written (the rest of the ring is unwritten memory)
        assert rows >= 1
        for k, v in jax_buffer["buffer"].items():
            assert mine["buffer"][k].shape == v.shape and mine["buffer"][k].dtype == v.dtype, k
            if k != "actions":
                np.testing.assert_array_equal(mine["buffer"][k][:rows], v[:rows], err_msg=k)
        for actions in (mine["buffer"]["actions"][:rows], jax_buffer["buffer"]["actions"][:rows]):
            for head in np.split(actions.reshape(rows, -1), np.cumsum(HEADS)[:-1], axis=-1):
                # a straight-through one-hot (one + p - p), or the zeros of a row stored at a reset
                np.testing.assert_allclose(head, np.round(head), atol=1e-6)
                assert set(np.round(head).sum(-1).tolist()) <= {0.0, 1.0}


def _minedojo_batch(cfg):
    """T steps of B envs of the port's env pipeline over the stand-in, acting at random: MineDojo's encoder keys,
    the three heads' one-hot actions, rewards, dones and is_first as the buffer stores them."""
    rng = np.random.default_rng(6)
    envs = [build_env(cfg, 7 + i, 0, vector_env_idx=i) for i in range(B)]
    obs = [env.reset(seed=7 + i)[0] for i, env in enumerate(envs)]
    rows = {k: [] for k in ["rgb", *MLP, "actions", "rewards", "dones", "is_first"]}
    for t in range(T):
        heads = [rng.integers(0, d, B) for d in HEADS]
        for k in ["rgb", *MLP]:
            rows[k].append(np.stack([o[k] for o in obs]).astype(np.uint8 if k == "rgb" else np.float32))
        rows["actions"].append(np.concatenate([np.eye(d, dtype=np.float32)[h] for d, h in zip(HEADS, heads)], -1))
        steps = [env.step(np.array([h[i] for h in heads])) for i, env in enumerate(envs)]
        obs = [s[0] for s in steps]
        rows["rewards"].append(np.array([[s[1]] for s in steps], np.float32))
        rows["dones"].append(np.zeros((B, 1), np.float32))
        rows["is_first"].append(np.full((B, 1), float(t == 0), np.float32))
    return {k: np.stack(v) for k, v in rows.items()}


def _jax_noise(key):
    """The JAX step's Gumbel noise re-derived from its key (``test_torch_dreamer_v3_train.py``'s schedule), for
    MineDojo's three heads."""
    key = jax.random.fold_in(key, 0)
    k_wm, k_img = jax.random.split(key)
    posterior = jax.random.gumbel(k_wm, (T, B, S, D))
    k0, key = jax.random.split(k_img)
    k_gum, key = jax.random.split(key)
    prior = jax.random.gumbel(k_gum, (HORIZON, T * B, S, D))
    heads = [[] for _ in HEADS]
    for k in [k0] + list(jax.random.split(key, HORIZON)):
        for j, kh in enumerate(jax.random.split(k, len(HEADS))):
            heads[j].append(np.asarray(jax.random.gumbel(kh, (T * B, HEADS[j]))))
    return {"posterior": torch.from_numpy(np.array(posterior)), "prior": torch.from_numpy(np.array(prior)),
            "actions": [torch.from_numpy(np.stack(h)) for h in heads]}


@pytest.mark.parametrize("tau", [0.02, 1.0])
def test_the_first_minedojo_gradient_step_matches_jax(sims, tau):
    overrides = ["exp=dreamer_v3", "env=minedojo", *SMALL]
    cfg = compose(overrides=overrides)
    batch = _minedojo_batch(cfg)
    shapes = {k: batch[k].shape[2:] for k in ["rgb", *MLP]}
    space = gym.spaces.Dict({k: gym.spaces.Box(0, 255, s, np.uint8) if k == "rgb"
                             else gym.spaces.Box(-np.inf, np.inf, s, np.float32) for k, s in shapes.items()})
    fabric = Fabric(devices=1, accelerator="cpu")
    jcfg = jax_compose(overrides=overrides)
    wm, actor, critic, params = jit_build(jax_agent.build_agent, jcfg, HEADS, False, space, jax.random.PRNGKey(5))
    rng = np.random.RandomState(8)  # the reward and critic heads start at zero (Hafner): move them, and the target
    for tree in (params["world_model"]["reward_model"], params["critic"]):
        tree["head"]["kernel"] = jnp.asarray(0.3 * rng.randn(*tree["head"]["kernel"].shape).astype(np.float32))
    params["target_critic"] = jax.tree_util.tree_map(lambda p: 0.5 * p, params["critic"])
    txs = jax_dv3.build_optimizers_and_state(jcfg, params)
    train_fn = jax_dv3.build_train_fn(wm, actor, critic, *txs[:3], jcfg, fabric, HEADS, False)
    key = jax.random.PRNGKey(11)
    new_state, j_metrics = train_fn(jax.tree_util.tree_map(jnp.array, txs[3]),
                                    {k: jnp.asarray(v) for k, v in batch.items()}, key, jnp.float32(tau))
    new_state, j_metrics = jax.device_get(new_state), jax.device_get(j_metrics)

    modules = build_agent(cfg, HEADS, False, shapes, device="cpu", training=True)
    state_dicts, skipped = convert_dreamer_v3(jax.device_get(params), training=True)
    assert skipped == []
    for name, module in zip(("world_model", "actor", "critic", "target_critic"), modules):
        module.load_state_dict(state_dicts[name])
    state = build_optimizers_and_state(cfg, *modules)
    metrics = build_train_fn(cfg, HEADS, False)(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                                                _jax_noise(key), tau=tau)
    _check_metrics(metrics, j_metrics)
    _check_first_moments(state, new_state)
    _check_params(state, new_state)

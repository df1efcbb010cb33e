"""The port's CLI, training run and checkpoint serving against the JAX package.

One tiny JAX DreamerV2 CLI dry run (the argument list of
``tests/test_algos/test_dreamer_v2.py``) writes a checkpoint and its
``.hydra/config.yaml``; a module-scoped fixture shares it. On it:

- the port's ``load_gateway_model(..., device="cpu")`` serves the actions
  the JAX package's ``load_gateway_model`` serves for the same observations,
  with the same pre-drawn posterior noise injected on both sides (three
  chained steps; recurrent and stochastic state within atol 1e-4, sampled
  categories and actions equal);
- the port reads the JAX run's config (targets rewritten to the port).

And the port's own CLI: ``python -m sheeprl_tpu_torch <the same tiny args>
fabric.accelerator=cpu`` completes and writes a checkpoint the JAX package
deep-validates, then resumes from it; ``load_gateway_model`` serves it.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax_cli_switches import run_jax_cli
import torch

from sheeprl_tpu.algos.dreamer_v2 import agent as jax_agent
from sheeprl_tpu.ckpt import validate_checkpoint as jax_validate_checkpoint
from sheeprl_tpu.serve.model import load_gateway_model as jax_load_gateway_model
from sheeprl_tpu_torch.cli import load_run_config
from sheeprl_tpu_torch.serve.model import load_gateway_model

REPO = Path(__file__).resolve().parents[1]
S = D = 4  # the tiny run's stochastic and discrete sizes
ROWS, STEPS = 3, 3


def tiny_args(root, run_name):
    return [
        "dry_run=True",
        "env=dummy",
        "env.sync_env=True",
        "checkpoint.every=1000000",
        "metric.log_every=1000000",
        "metric.log_level=0",
        "env.capture_video=False",
        "buffer.memmap=False",
        "env.num_envs=2",
        f"root_dir={root}",
        f"run_name={run_name}",
        "exp=dreamer_v2",
        "per_rank_batch_size=2",
        "per_rank_sequence_length=2",
        "algo.horizon=4",
        "algo.dense_units=8",
        "algo.mlp_layers=1",
        "algo.per_rank_pretrain_steps=1",
        "algo.world_model.encoder.cnn_channels_multiplier=2",
        "algo.world_model.recurrent_model.recurrent_state_size=8",
        "algo.world_model.transition_model.hidden_size=8",
        "algo.world_model.representation_model.hidden_size=8",
        f"algo.world_model.stochastic_size={S}",
        f"algo.world_model.discrete_size={D}",
        "algo.learning_starts=0",
        "cnn_keys.encoder=[rgb]",
        "env.id=discrete_dummy",
    ]


def _checkpoint(root):
    found = sorted(Path(root).rglob("ckpt_*_0"))
    assert len(found) == 1, found
    return str(found[0])


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """One tiny JAX DreamerV2 dry run; returns its checkpoint directory."""
    root = tmp_path_factory.mktemp("jax_dv2")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        run_jax_cli(tiny_args(root / "logs", "jax"))
    finally:
        os.chdir(cwd)
    return _checkpoint(root / "logs")


def test_the_jax_run_leaves_the_jax_timer_recording(jax_run):
    """The JAX CLI turns the JAX timer off for the whole process at
    ``metric.log_level=0``; ``run_jax_cli`` puts it back, so a span timed
    after the JAX run is in the timer's registry (``tests/test_obs/
    test_spans.py`` on the same worker reads it)."""
    from sheeprl_tpu.utils.timer import timer

    name = "Time/after_the_jax_run"
    assert not timer.disabled
    with timer(name):
        pass
    assert name in timer.timers
    timer.timers.pop(name)


def test_run_jax_cli_puts_the_default_key_implementation_back(monkeypatch):
    """The JAX Fabric switches JAX's default key implementation for the
    whole process; ``run_jax_cli`` puts it back with the timer switches, so
    a later test's ``PRNGKey`` draws what it drew before the JAX run."""
    import jax
    from sheeprl_tpu import cli as jax_cli
    from sheeprl_tpu.utils.timer import timer

    before = jax.config.jax_default_prng_impl
    other = "rbg" if before != "rbg" else "threefry2x32"

    def switching_run(args):
        jax.config.update("jax_default_prng_impl", other)
        timer.disabled = True
        return list(args)

    monkeypatch.setattr(jax_cli, "run", switching_run)
    assert run_jax_cli(["a=1"]) == ["a=1"]
    assert jax.config.jax_default_prng_impl == before
    assert not timer.disabled


def test_the_port_reads_the_jax_run_config(jax_run):
    cfg, log_dir = load_run_config(jax_run)
    assert cfg.algo.name == "dreamer_v2" and cfg.algo.world_model.stochastic_size == S
    assert cfg.fabric._target_ == "sheeprl_tpu_torch.fabric.Fabric"
    assert cfg.env.wrapper._target_ == "sheeprl_tpu_torch.utils.env.get_dummy_env"
    assert log_dir == str(Path(jax_run).parents[1])


def test_a_jax_checkpoint_serves_the_jax_actions(jax_run, monkeypatch):
    rng = np.random.RandomState(0)
    noise = rng.gumbel(size=(ROWS, S, D)).astype(np.float32)
    frames = [rng.randint(0, 256, (ROWS, 3, 64, 64)).astype(np.uint8) for _ in range(STEPS)]

    # the JAX policy samples its posterior inside a jitted step: inject the same noise there (the
    # served batches have ROWS rows; the model's initialisation calls it on one row)
    sample = jax_agent.compute_stochastic_state

    def injected(logits, discrete, key, sample_state=True, gumbel=None):
        if logits.shape[0] == ROWS:
            gumbel = jnp.asarray(noise)
        return sample(logits, discrete, key, sample_state, gumbel=gumbel)

    monkeypatch.setattr(jax_agent, "compute_stochastic_state", injected)
    jax_model, *_ = jax_load_gateway_model(jax_run)
    model, cfg, observation_space, action_space = load_gateway_model(jax_run, device="cpu")
    assert (model.version, model.algo, model.env_id) == (jax_model.version, "dreamer_v2", "discrete_dummy")
    assert action_space.n == 2 and observation_space["rgb"].shape == (3, 64, 64)

    jax_state, state = jax_model.init_state_rows(ROWS), model.init_state_rows(ROWS)
    for obs in frames:
        # the key is split but the injected noise replaces what it would draw
        jax_actions, jax_state = jax_model.act({"rgb": obs}, jax_state, jax.random.PRNGKey(0))
        actions, state = model.policy.act({"rgb": obs}, state, None, gumbel=torch.from_numpy(noise))
        np.testing.assert_array_equal(actions, np.asarray(jax_actions))
        np.testing.assert_allclose(state["recurrent"].numpy(), np.asarray(jax_state["recurrent"]), atol=1e-4, rtol=0)
        stochastic, jax_stochastic = state["stochastic"].numpy(), np.asarray(jax_state["stochastic"])
        np.testing.assert_allclose(stochastic, jax_stochastic, atol=1e-4, rtol=0)  # one-hot + p - p: rounding
        np.testing.assert_array_equal(
            stochastic.reshape(ROWS, S, D).argmax(-1), jax_stochastic.reshape(ROWS, S, D).argmax(-1)
        )


def _port_cli(args, cwd):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "sheeprl_tpu_torch", *args, "fabric.accelerator=cpu"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return proc


def test_the_port_cli_trains_checkpoints_resumes_and_serves(tmp_path):
    _port_cli(tiny_args(tmp_path / "logs", "port"), tmp_path)
    ckpt = _checkpoint(tmp_path / "logs")
    manifest = jax_validate_checkpoint(ckpt, deep=True)
    assert manifest["framework"] == "torch" and manifest["algo"] == "dreamer_v2"
    assert (Path(ckpt).parents[1] / ".hydra" / "config.yaml").is_file()

    proc = _port_cli(tiny_args(tmp_path / "logs", "resumed") + [f"checkpoint.resume_from={ckpt}"], tmp_path)
    assert "Test - Reward" in proc.stdout
    assert len(list((tmp_path / "logs" / "resumed").rglob("ckpt_*_0"))) == 1

    model, *_ = load_gateway_model(ckpt, device="cpu")
    actions, state = model.act({"rgb": np.zeros((2, 3, 64, 64), np.uint8)}, model.init_state_rows(2),
                               torch.Generator().manual_seed(0))
    assert actions.shape == (2, 1) and set(actions.ravel()) <= {0, 1}
    assert torch.isfinite(state["recurrent"]).all()

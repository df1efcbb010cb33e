"""PPO through both CLIs at ``fabric.devices=2`` on the CPU: the port's two
gloo ranks against the JAX package's two devices for the same command,
then the port's run resumed at two ranks (``tests/ddp_cli.py`` says what
each run is held to)."""

import pytest
from ddp_cli import check_resume, check_run, run_both

import cpu_threads  # noqa: F401  (one CPU thread a process)
from test_torch_ppo import restore_prng_impl  # noqa: F401  (a module fixture: the JAX CLI's Fabric)

ARGS = ["exp=ppo", "env=dummy", "cnn_keys.encoder=[rgb]", "mlp_keys.encoder=[]", "algo.rollout_steps=8",
        "per_rank_batch_size=8", "algo.update_epochs=2", "algo.dense_units=8", "algo.encoder.cnn_features_dim=8",
        "buffer.size=8", "total_steps=96"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_both(str(tmp_path_factory.mktemp("ddp_ppo")), ARGS)


def test_the_two_rank_run_counts_checkpoints_and_logs_as_the_jax_run(runs):
    check_run(runs)


def test_the_two_rank_run_resumes_at_two_ranks(runs):
    check_resume(runs, total_steps=160)

"""DreamerV3 through both CLIs at ``fabric.devices=2`` on the CPU: the
port's two gloo ranks against the JAX package's two devices for the same
command, then the port's run resumed at two ranks (``tests/ddp_cli.py``
says what each run is held to)."""

import pytest
from ddp_cli import check_resume, check_run, run_both

import cpu_threads  # noqa: F401  (one CPU thread a process)

ARGS = ["exp=dreamer_v3", "env=dummy", "env.id=discrete_dummy", "env.sync_env=True", "per_rank_batch_size=2",
        "per_rank_sequence_length=4", "algo.horizon=4", "algo.dense_units=8", "algo.mlp_layers=1",
        "algo.world_model.encoder.cnn_channels_multiplier=2", "algo.world_model.recurrent_model.recurrent_state_size=8",
        "algo.world_model.transition_model.hidden_size=8", "algo.world_model.representation_model.hidden_size=8",
        "algo.world_model.stochastic_size=4", "algo.world_model.discrete_size=4",
        "buffer.size=64", "total_steps=64", "algo.learning_starts=16", "algo.train_every=8"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_both(str(tmp_path_factory.mktemp("ddp_dv3")), ARGS)


def test_the_two_rank_run_counts_checkpoints_and_logs_as_the_jax_run(runs):
    check_run(runs)


def test_the_two_rank_run_resumes_at_two_ranks(runs):
    check_resume(runs, total_steps=96)

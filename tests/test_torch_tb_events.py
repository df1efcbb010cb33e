"""The port's TensorBoard event files against tensorboardX's.

- crc32c (Castagnoli) gives the known check values and tensorboardX's crc
  on random bytes;
- a file the port writes parses with tensorboardX's ``event_pb2`` into the
  same events (tags, steps, values, text tensors and plugin metadata, every
  field but the wall time) as tensorboardX's ``SummaryWriter`` writes for
  the same calls, and the port's reader reads tensorboardX's file back
  equal; a flipped byte is refused;
- the port's logger and metric layer (aggregator, timers, rate gauges);
- a CPU run at ``metric.log_level=1`` of both packages, every update in the
  random phase, logs the same ``Rewards/rew_avg`` and ``Game/ep_len_avg``
  at the same policy steps, under the same tags at every step.
"""

import glob
import os
import struct
import time

import numpy as np
import pytest
from jax_cli_switches import run_jax_cli
from tensorboardX import SummaryWriter
from tensorboardX.crc32c import crc32c as tbx_crc32c
from tensorboardX.proto import event_pb2

from sheeprl_tpu_torch.obs.perf import log_sps_metrics
from sheeprl_tpu_torch.utils.logger import TensorBoardLogger
from sheeprl_tpu_torch.utils.metric import MeanMetric, MetricAggregator, SumMetric
from sheeprl_tpu_torch.utils.tb_events import EventFileWriter, crc32c, masked_crc32c, read_events
from sheeprl_tpu_torch.utils.timer import timer


def _records(path):
    data = open(path, "rb").read()
    out, i = [], 0
    while i < len(data):
        (n,) = struct.unpack("<Q", data[i : i + 8])
        out.append(data[i + 12 : i + 12 + n])
        i += 16 + n
    return out


def _parsed(path):
    """Every event of ``path`` through protobuf, wall time zeroed."""
    events = []
    for body in _records(path):
        e = event_pb2.Event()
        e.ParseFromString(body)
        e.wall_time = 0.0
        events.append(e)
    return events


def _calls(writer):
    writer.add_scalar("Loss/world_model_loss", 12.5, 40)
    writer.add_scalar("Rewards/rew_avg", -3.25, 80)
    writer.add_scalar("bad tag!", 1e-9, 81)  # tensorboardX replaces the illegal characters
    writer.add_scalar("Time/sps_train", np.float32(7.0), 2**40)
    writer.add_scalar("Test/cumulative_reward", float("nan"), 0)
    writer.add_text("hparams", "```yaml\nseed: 5\nname: é\n```")


@pytest.mark.parametrize(
    "data,want",
    [(b"", 0), (b"123456789", 0xE3069283), (bytes(32), 0x8A9136AA), (b"\xff" * 32, 0x62A8AB43),
     (bytes(range(32)), 0x46DD794E)],
)
def test_crc32c_known_vectors(data, want):
    assert crc32c(data) == want == tbx_crc32c(data)


def test_crc32c_matches_tensorboardx_on_random_bytes():
    rng = np.random.default_rng(0)
    for n in (1, 7, 8, 63, 1000):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert crc32c(data) == tbx_crc32c(data)
    assert masked_crc32c(b"") == ((0 >> 15 | 0 << 17) + 0xA282EAD8) & 0xFFFFFFFF


def test_event_file_equals_tensorboardx(tmp_path):
    ours = EventFileWriter(str(tmp_path / "port"))
    _calls(ours)
    ours.close()
    theirs = SummaryWriter(str(tmp_path / "tbx"))
    _calls(theirs)
    theirs.close()
    (tbx_path,) = glob.glob(str(tmp_path / "tbx" / "events.out.tfevents.*"))
    assert os.path.basename(ours.path).split(".")[:3] == os.path.basename(tbx_path).split(".")[:3]
    assert os.path.basename(ours.path).split(".", 4)[4] == os.path.basename(tbx_path).split(".", 4)[4]  # the host
    want, got = _parsed(tbx_path), _parsed(ours.path)
    assert len(got) == len(want) == 7
    assert got[0].file_version == "brain.Event:2"
    for g, w in zip(got, want):
        assert g == w
        assert g.SerializeToString() == w.SerializeToString()
    # the port's reader on tensorboardX's file
    read = read_events(tbx_path)
    assert [e["step"] for e in read] == [e.step for e in want]
    scalars = [(e["step"], v["tag"], v["simple_value"]) for e in read for v in e.get("values", []) if "simple_value" in v]
    assert scalars[:4] == [(40, "Loss/world_model_loss", 12.5), (80, "Rewards/rew_avg", -3.25),
                           (81, "bad_tag_", np.float32(1e-9)), (2**40, "Time/sps_train", 7.0)]
    assert np.isnan(scalars[4][2])
    (text,) = [v for e in read for v in e.get("values", []) if "string_val" in v]
    assert text == {"tag": "hparams/text_summary", "string_val": ["```yaml\nseed: 5\nname: é\n```"], "plugin_name": "text"}


def test_a_damaged_event_file_is_refused(tmp_path):
    w = EventFileWriter(str(tmp_path))
    w.add_scalar("a", 1.0, 1)
    w.close()
    data = bytearray(open(w.path, "rb").read())
    data[-6] ^= 0xFF
    open(w.path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="checksum"):
        read_events(w.path)
    open(w.path, "wb").write(bytes(data[:-3]))
    with pytest.raises(ValueError, match="torn"):
        read_events(w.path)


def test_logger_aggregator_timers_and_rates(tmp_path):
    logger = TensorBoardLogger(str(tmp_path))
    logger.log_hyperparams({"seed": 5, "algo": {"name": "dreamer_v2", "lr": 2e-4, "keys": ["rgb"]}})
    agg = MetricAggregator({"Rewards/rew_avg": MeanMetric(), "Loss/x": SumMetric()}, raise_on_missing=False)
    for v in (1.0, 2.0, 6.0):
        agg.update("Rewards/rew_avg", v)
    agg.update("Not/there", 1.0)  # silently skipped
    assert agg.compute() == {"Rewards/rew_avg": 3.0, "Loss/x": 0.0}  # the empty mean (NaN) is dropped
    logger.log_metrics(agg.compute(), 16)
    agg.reset()
    assert agg.compute() == {"Loss/x": 0.0}
    strict = MetricAggregator({}, raise_on_missing=True)
    with pytest.raises(KeyError):
        strict.update("Loss/x", 1.0)
    MetricAggregator.disabled = True
    try:
        agg.update("Rewards/rew_avg", 5.0)
        assert agg.compute() == {}
    finally:
        MetricAggregator.disabled = False

    timer.reset()
    with timer("Time/train_time"):
        time.sleep(0.01)
    with timer("Time/env_interaction_time"):
        time.sleep(0.01)
        timer.reset()  # a reset mid-scope: the scope registers a fresh metric on exit
    gauges = log_sps_metrics(logger, policy_step=32, last_log=16, train_step=4, last_train=2, action_repeat=2)
    assert set(gauges) == {"Time/sps_env_interaction"} and 0 < gauges["Time/sps_env_interaction"] < 16 * 2 / 0.01
    assert timer.compute() == {}  # read and reset
    timer.disabled = True
    try:
        assert log_sps_metrics(logger, policy_step=48, last_log=32) == {}
    finally:
        timer.disabled = False
    logger.close()
    events = read_events(logger.path)
    assert [(e["step"], [v["tag"] for v in e["values"]]) for e in events[1:]] == [
        (0, ["hparams/text_summary"]), (16, ["Rewards/rew_avg"]), (16, ["Loss/x"]), (32, ["Time/sps_env_interaction"])
    ]
    import yaml  # the port's YAML reads back as PyYAML reads it

    text = events[1]["values"][0]["string_val"][0]
    assert text.startswith("```yaml\n") and text.endswith("\n```")
    assert yaml.safe_load(text[len("```yaml\n"):-len("\n```")]) == {
        "seed": 5, "algo": {"name": "dreamer_v2", "lr": 2e-4, "keys": ["rgb"]}
    }


def _episode_scalars(path):
    out = {}
    for e in _parsed(path):
        for v in e.summary.value:
            out.setdefault(e.step, {})[v.tag] = v.simple_value
    return out


def test_a_log_level_1_run_logs_the_jax_episode_metrics(tmp_path, monkeypatch):
    """Both CLIs at ``metric.log_level=1`` on the dummy env with every update
    random (``learning_starts`` past the run): the same seeded episodes, so
    the same episode metrics at the same log boundaries."""
    from sheeprl_tpu_torch import cli

    args = ["exp=dreamer_v2", "env=dummy", "env.id=discrete_dummy", "env.sync_env=True", "env.num_envs=2",
            "total_steps=64", "algo.learning_starts=1000", "buffer.size=64", "buffer.memmap=False",
            "metric.log_level=1", "metric.log_every=12", "algo.dense_units=8", "algo.mlp_layers=1",
            "algo.world_model.encoder.cnn_channels_multiplier=2",
            "algo.world_model.recurrent_model.recurrent_state_size=8",
            "algo.world_model.transition_model.hidden_size=8", "algo.world_model.representation_model.hidden_size=8",
            "algo.world_model.stochastic_size=4", "algo.world_model.discrete_size=4", "fabric.accelerator=cpu",
            "algo.run_test=False"]
    from sheeprl_tpu.utils import logger as jax_logger

    made = []  # the JAX run leaves its SummaryWriter open: close it to flush its queue
    jax_init = jax_logger.TensorBoardLogger.__init__

    def init(self, log_dir):
        jax_init(self, log_dir)
        made.append(self)

    monkeypatch.setattr(jax_logger.TensorBoardLogger, "__init__", init)
    monkeypatch.chdir(tmp_path)
    run_jax_cli(args + [f"root_dir={tmp_path}/jax", "run_name=jax"])
    for jax_tb in made:
        jax_tb.close()
    result = cli.run(args + [f"root_dir={tmp_path}/port", "run_name=port"])
    (jax_path,) = glob.glob(str(tmp_path / "jax" / "**" / "events.out.tfevents.*"), recursive=True)
    theirs, ours = _episode_scalars(jax_path), _episode_scalars(result["event_file"])
    assert sorted(ours) == sorted(theirs) == [0, 12, 24, 36, 48, 60, 64]
    for step in ours:
        assert set(ours[step]) == set(theirs[step]), step
        for tag in ("Rewards/rew_avg", "Game/ep_len_avg"):
            if tag in theirs[step]:
                assert ours[step][tag] == theirs[step][tag], (step, tag)
    assert sum("Game/ep_len_avg" in m for m in ours.values()) >= 4

"""The port's ``EpisodeBuffer`` against the JAX package's.

- the same adds and seed give bit-identical samples, ``prioritize_ends`` on
  and off, in memory and memory-mapped, and equal ``state_dict``s (the
  stored episodes and each env's open episode);
- episodes shorter than the sequence length are dropped, and the oldest
  episode is evicted once the stored steps would pass the buffer's size
  (its memory-mapped files removed with it);
- ``end_biased_start`` is the JAX draw;
- ``make_replay_buffer`` builds the episode buffer for ``buffer.type=episode``
  with the JAX sizing (the sequence length is the only floor), and host
  staging samples it through its own arguments;
- a checkpoint holding the buffer passes the JAX package's deep validation
  and restores into a fresh buffer with an equal ``state_dict``.
"""

import os

import jax
import numpy as np
import pytest
import torch

from sheeprl_tpu.ckpt import validate_checkpoint as jax_validate_checkpoint
from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.data import buffers as jax_buffers
from sheeprl_tpu.replay import make_replay_buffer as jax_make_replay_buffer
from sheeprl_tpu_torch.ckpt import CheckpointManager, read_checkpoint
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.data import buffers
from sheeprl_tpu_torch.data.staging import HostStaging, make_replay_staging
from sheeprl_tpu_torch.fabric import Fabric
from sheeprl_tpu_torch.replay import make_replay_buffer
from sheeprl_tpu_torch.utils.callback import CheckpointCallback

N_ENVS, SEQ = 3, 4


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


def _rows(rng, t, n=N_ENVS, p_done=0.15):
    return {
        "rgb": rng.integers(0, 256, (t, n, 3, 4, 4), dtype=np.uint8),
        "actions": rng.normal(size=(t, n, 2)).astype(np.float32),
        "dones": (rng.random((t, n, 1)) < p_done).astype(np.float32),
    }


def _pair(size, tmp_path=None, prioritize_ends=False):
    out = []
    for pkg, name in ((jax_buffers, "jax"), (buffers, "port")):
        mm = dict(memmap=True, memmap_dir=str(tmp_path / name)) if tmp_path is not None else {}
        b = pkg.EpisodeBuffer(size, SEQ, n_envs=N_ENVS, obs_keys=("rgb",), prioritize_ends=prioritize_ends, **mm)
        b.seed(7)
        out.append(b)
    return out


def _fill(bufs, rng, steps, p_done=0.15):
    for step in range(steps):
        rows = _rows(rng, 1 if step % 3 else 2, p_done=p_done)
        for b in bufs:
            b.add({k: v.copy() for k, v in rows.items()})
        if step % 5 == 4:  # reset rows for two envs, out of order
            extra = _rows(rng, 1, 2, p_done=0.0)
            for b in bufs:
                b.add({k: v.copy() for k, v in extra.items()}, [2, 0])


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def _assert_same_state(a, b):
    assert len(a["buffer"]) == len(b["buffer"])
    for ea, eb in zip(a["buffer"], b["buffer"]):
        _assert_same(ea, eb)
    assert len(a["open_episodes"]) == len(b["open_episodes"])
    for ca, cb in zip(a["open_episodes"], b["open_episodes"]):
        assert len(ca) == len(cb)
        for x, y in zip(ca, cb):
            _assert_same(x, y)


@pytest.mark.parametrize("memmap", [False, True], ids=["ram", "memmap"])
@pytest.mark.parametrize("prioritize_ends", [False, True], ids=["uniform", "prioritize_ends"])
def test_same_adds_and_seed_give_identical_samples(prioritize_ends, memmap, tmp_path):
    jax_buf, buf = _pair(40, tmp_path if memmap else None, prioritize_ends)
    rng = np.random.default_rng(0)
    for step in range(12):
        _fill((jax_buf, buf), rng, 6)
        assert len(buf) == len(jax_buf) and buf.full == jax_buf.full
        if len(buf):
            _assert_same(jax_buf.sample(5, n_samples=2), buf.sample(5, n_samples=2))
            if max(np.asarray(ep["dones"]).shape[0] for ep in buf.buffer) > SEQ:
                _assert_same(jax_buf.sample(3, sample_next_obs=True), buf.sample(3, sample_next_obs=True))
            # the per-call override of the buffer's own setting
            _assert_same(jax_buf.sample(2, prioritize_ends=not prioritize_ends),
                         buf.sample(2, prioritize_ends=not prioritize_ends))
        _assert_same_state(jax_buf.state_dict(), buf.state_dict())
    sample = buf.sample(5, n_samples=2)
    assert sample["rgb"].shape == (2, SEQ, 5, 3, 4, 4) and sample["dones"].shape == (2, SEQ, 5, 1)


def test_end_biased_start_is_the_jax_draw():
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    for length in range(1, 40):
        for upper in (0, length // 2, length - 1):
            assert buffers.end_biased_start(a, length, upper) == jax_buffers.end_biased_start(b, length, upper)


def test_short_episodes_are_dropped_and_the_oldest_evicted(tmp_path):
    buf = buffers.EpisodeBuffer(14, SEQ, n_envs=1, obs_keys=("rgb",), memmap=True, memmap_dir=str(tmp_path))

    def episode(length, tag):
        dones = np.zeros((length, 1, 1), np.float32)
        dones[-1] = 1.0
        return {"rgb": np.full((length, 1, 1), tag, np.uint8), "dones": dones}

    buf.add(episode(3, 1))  # shorter than the sequence length
    assert len(buf) == 0 and buf.state_dict()["open_episodes"] == [[]]
    buf.add(episode(4, 2))
    buf.add(episode(5, 3))
    assert [int(ep["rgb"][0, 0]) for ep in buf.buffer] == [2, 3] and not buf.full
    first_dir = os.path.dirname(buf.buffer[0]["rgb"].filename)
    buf.add(episode(6, 4))  # 4 + 5 + 6 > 14: the oldest goes
    assert [int(ep["rgb"][0, 0]) for ep in buf.buffer] == [3, 4] and buf.full
    assert not os.path.exists(first_dir)
    # an episode split over several adds stays open until its done
    half = episode(8, 5)
    buf.add({k: v[:5] for k, v in half.items()})
    assert len(buf.state_dict()["open_episodes"][0]) == 1 and len(buf) == 2
    buf.add({k: v[5:] for k, v in half.items()})
    assert [int(ep["rgb"][0, 0]) for ep in buf.buffer] == [4, 5] and buf.buffer[1]["rgb"].shape[0] == 8
    with pytest.raises(RuntimeError, match="exactly one done"):
        buf.save_episode({"dones": np.ones((5, 1), np.float32)})
    with pytest.raises(ValueError, match="sequence length must be lower"):
        buffers.EpisodeBuffer(3, SEQ)


@pytest.mark.parametrize("dry_run", [False, True])
def test_factory_builds_the_jax_episode_buffer(tmp_path, dry_run):
    overrides = ["exp=dreamer_v2_ms_pacman", "env=dummy", "buffer.size=1000", f"dry_run={dry_run}"]
    cfg, jax_cfg = compose(overrides=overrides), jax_compose(overrides=overrides)
    kwargs = dict(n_envs=4, kind="dreamer", obs_keys=("rgb",), min_size=8, dry_run_size=8, sequence_length=50)
    rb = make_replay_buffer(cfg, Fabric(accelerator="cpu"), str(tmp_path / "port"), **kwargs)
    jax_rb = jax_make_replay_buffer(jax_cfg, Fabric(accelerator="cpu"), str(tmp_path / "jax"), **kwargs)
    assert isinstance(rb, buffers.EpisodeBuffer) and isinstance(jax_rb, jax_buffers.EpisodeBuffer)
    # buffer.size // n_envs, floored at the sequence length (50 under dry_run, not min_size's 8)
    assert (rb.buffer_size, rb.sequence_length, rb.prioritize_ends, rb.is_memmap) == (
        jax_rb.buffer_size, jax_rb.sequence_length, jax_rb.prioritize_ends, jax_rb.is_memmap
    ) == (50 if dry_run else 250, 50, True, cfg.buffer.memmap)


@pytest.mark.parametrize("prefetch", [False, True], ids=["sync", "prefetch"])
def test_host_staging_samples_the_episode_buffer(prefetch):
    jax_buf, buf = _pair(60, prioritize_ends=True)
    _fill((jax_buf, buf), np.random.default_rng(2), 40)
    cfg = compose(overrides=["exp=dreamer_v2_ms_pacman", "env=dummy", f"buffer.prefetch={prefetch}"])
    staging = make_replay_staging(cfg, Fabric(accelerator="cpu"), buf, seed=9)
    jax_buf.seed(9)
    assert isinstance(staging, HostStaging) and staging._seq
    try:
        for _ in range(3):
            got = staging.sample_device(4, sequence_length=SEQ, n_samples=2)
            _assert_same(jax_buf.sample(4, n_samples=2, sequence_length=SEQ), {k: v.numpy() for k, v in got.items()})
        with pytest.raises(NotImplementedError, match="per-env sequence buffers"):
            staging.force_done_last(0)
    finally:
        staging.close()
    assert staging.prefetch_hits == (1 if prefetch else 0)


def test_checkpoint_with_the_episode_buffer_passes_jax_deep_validation(tmp_path):
    rb = buffers.EpisodeBuffer(60, SEQ, n_envs=N_ENVS, obs_keys=("rgb",))
    _fill((rb,), np.random.default_rng(4), 40)
    assert len(rb) and any(rb.state_dict()["open_episodes"])
    path = tmp_path / "checkpoint" / "ckpt_40_0"
    CheckpointManager(async_save=False).save(
        str(path), {"update": 40, "w": torch.ones(3)}, rb_state=CheckpointCallback._buffer_state(rb)
    )
    manifest = jax_validate_checkpoint(str(path), deep=True)
    assert manifest["framework"] == "torch" and manifest["rb"]["kind"] == "tree"
    fresh = buffers.EpisodeBuffer(60, SEQ, n_envs=N_ENVS, obs_keys=("rgb",))
    fresh.load_state_dict(read_checkpoint(str(path))["rb"])
    _assert_same_state(rb.state_dict(), fresh.state_dict())
    rb.seed(1)
    fresh.seed(1)
    _assert_same(rb.sample(6, n_samples=2), fresh.sample(6, n_samples=2))
    # the restored open episodes close as they would have
    closing = {"rgb": np.zeros((1, N_ENVS, 3, 4, 4), np.uint8), "actions": np.zeros((1, N_ENVS, 2), np.float32),
               "dones": np.ones((1, N_ENVS, 1), np.float32)}
    rb.add({k: v.copy() for k, v in closing.items()})
    fresh.add({k: v.copy() for k, v in closing.items()})
    _assert_same_state(rb.state_dict(), fresh.state_dict())


def test_the_preset_runs_on_the_cpu_with_its_episode_buffer_and_logging(tmp_path):
    """``exp=dreamer_v2_ms_pacman`` on the CPU at small widths with the
    preset's episode buffer (``prioritize_ends``) and ``log_level=1``: its
    event file parses with tensorboardX's ``event_pb2``, and its checkpoint
    holds the episode buffer, passes the JAX package's deep validation and
    resumes."""
    import struct

    from tensorboardX.proto import event_pb2

    from sheeprl_tpu_torch import cli

    args = ["exp=dreamer_v2_ms_pacman", "env=dummy", "env.id=multidiscrete_dummy", "env.num_envs=2",
            "env.sync_env=True", "fabric.accelerator=cpu", "buffer.size=600", "total_steps=288",
            "algo.learning_starts=264", "metric.log_every=96", "per_rank_batch_size=2", "per_rank_sequence_length=8",
            "algo.horizon=3", "algo.dense_units=8", "algo.mlp_layers=1",
            "algo.world_model.encoder.cnn_channels_multiplier=2",
            "algo.world_model.recurrent_model.recurrent_state_size=8",
            "algo.world_model.transition_model.hidden_size=8", "algo.world_model.representation_model.hidden_size=8",
            "algo.world_model.stochastic_size=4", "algo.world_model.discrete_size=4", f"root_dir={tmp_path}",
            "run_name=preset"]
    result = cli.run(args)
    assert result["gradient_steps"] > 0 and result["player_steps"] > 0
    data = open(result["event_file"], "rb").read()
    tags, i = {}, 0
    while i < len(data):
        (n,) = struct.unpack("<Q", data[i : i + 8])
        event = event_pb2.Event()
        event.ParseFromString(data[i + 12 : i + 12 + n])
        i += 16 + n
        for v in event.summary.value:
            tags.setdefault(v.tag, []).append(event.step)
    assert tags["Time/sps_env_interaction"] == [96, 192, 288]
    assert tags["Loss/world_model_loss"] == tags["Grads/world_model"] == [288]
    assert tags["Game/ep_len_avg"] == [288] and tags["Test/cumulative_reward"] == [0]
    ckpt = result["checkpoint"]
    assert jax_validate_checkpoint(ckpt, deep=True)["rb"]["kind"] == "tree"
    rb_state = read_checkpoint(ckpt)["rb"]
    assert len(rb_state["buffer"]) == 2 and [len(ep["dones"]) for ep in rb_state["buffer"]] == [130, 130]  # the reset row and 129 steps
    resumed = cli.run(args[:-1] + ["run_name=resumed", f"checkpoint.resume_from={ckpt}", "total_steps=320"])
    assert resumed["updates"] == 17 and resumed["gradient_steps"] == 2  # updates 144 to 160, a burst every 8

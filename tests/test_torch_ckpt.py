"""The port's checkpoints against the JAX package's reader and writer.

A checkpoint the port writes (module and optimizer state of tensors,
counters, and a replay-buffer state) passes the JAX package's
``validate_checkpoint(deep=True)``, and both packages' ``read_checkpoint``
give back its arrays bit for bit; a checkpoint the JAX package writes reads
back equal in the port. A corrupted or torn checkpoint is refused by both
packages' deep validation, and ``latest`` resolution (the quick check of
the manifest and the shard sizes) skips a torn one.
"""

import os

import numpy as np
import pytest
import torch

from sheeprl_tpu.ckpt import read_checkpoint as jax_read_checkpoint
from sheeprl_tpu.ckpt import validate_checkpoint as jax_validate_checkpoint
from sheeprl_tpu.ckpt.manifest import CheckpointCorruptedError as JaxCorrupted
from sheeprl_tpu.ckpt.writer import write_checkpoint as jax_write_checkpoint
from sheeprl_tpu_torch.ckpt import (
    CheckpointCorruptedError,
    CheckpointManager,
    read_checkpoint,
    resolve_latest,
    validate_checkpoint,
)
from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, SequentialReplayBuffer
from sheeprl_tpu_torch.utils.callback import CheckpointCallback


def _state():
    torch.manual_seed(0)
    module = torch.nn.Sequential(torch.nn.Linear(5, 4), torch.nn.LayerNorm(4))
    opt = torch.optim.AdamW(module.parameters(), lr=1e-3, weight_decay=1e-6)
    module(torch.randn(3, 5)).square().sum().backward()
    opt.step()
    return {
        "agent": {"module": module.state_dict(), "opt": {"state": opt.state_dict()["state"]}},
        "update": 7,
        "expl_decay_steps": 0,
        "flag": True,
        "nothing": None,
        "pair": (np.arange(3, dtype=np.int64), 2.5),
    }


def _buffer():
    rb = EnvIndependentReplayBuffer(6, 2, obs_keys=("rgb",), buffer_cls=SequentialReplayBuffer)
    rng = np.random.default_rng(0)
    for _ in range(8):
        rb.add({"rgb": rng.integers(0, 256, (1, 2, 3, 4, 4), dtype=np.uint8), "dones": np.zeros((1, 2, 1), np.float32)})
    return rb


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}/{i}"))
        return out
    return {prefix: None if tree is None else np.asarray(tree.detach() if isinstance(tree, torch.Tensor) else tree)}


def _write(path, state, rb=None):
    manager = CheckpointManager(async_save=False)
    rb_state = CheckpointCallback._buffer_state(rb) if rb is not None else None
    manager.save(str(path), state, rb_state=rb_state)
    return manager


def test_port_checkpoint_passes_jax_deep_validation_and_reads_back_equal(tmp_path):
    state, rb = _state(), _buffer()
    path = tmp_path / "checkpoint" / "ckpt_7_0"
    manager = _write(path, state, rb)
    manifest = jax_validate_checkpoint(str(path), deep=True)
    assert manifest["framework"] == "torch" and manifest["step"] == 7
    assert validate_checkpoint(str(path), deep=True)["files"] == manifest["files"]
    assert manager.stats["writes"] == 1 and manager.stats["bytes"] == sum(manifest["files"].values())
    want = _leaves(state)
    for restored in (jax_read_checkpoint(str(path)), read_checkpoint(str(path))):
        got = _leaves({k: v for k, v in restored.items() if k != "rb"})
        assert got.keys() == want.keys()
        for key, value in want.items():
            if value is None:
                assert got[key] is None
            else:
                np.testing.assert_array_equal(got[key], value)
                assert got[key].dtype == value.dtype
        fresh = EnvIndependentReplayBuffer(6, 2, obs_keys=("rgb",), buffer_cls=SequentialReplayBuffer)
        fresh.load_state_dict(restored["rb"])
        for ours, theirs in zip(fresh.buffer, rb.buffer):
            np.testing.assert_array_equal(ours["rgb"], theirs["rgb"])
        # the last stored step is forced terminal so a restored episode ends cleanly
        assert all(b["dones"][(b._pos - 1) % 6].item() == 1.0 for b in fresh.buffer)


def test_jax_checkpoint_reads_back_equal_in_the_port(tmp_path):
    state = {"agent": {"params": {"w": np.arange(12, dtype=np.float32).reshape(3, 4)}}, "update": 3, "t": (1, [2.0])}
    path = tmp_path / "ckpt_3_0"
    jax_write_checkpoint(str(path), state, step=3, algo="dreamer_v2")
    manifest = validate_checkpoint(str(path), deep=True)
    assert "framework" not in manifest
    restored = read_checkpoint(str(path))
    np.testing.assert_array_equal(restored["agent"]["params"]["w"], state["agent"]["params"]["w"])
    assert int(restored["update"]) == 3 and restored["t"][0] == 1 and list(restored["t"][1]) == [2.0]


@pytest.mark.parametrize("damage", ["flip", "truncate", "manifest", "missing"])
def test_a_corrupted_checkpoint_is_refused_by_both(tmp_path, damage):
    path = tmp_path / "checkpoint" / "ckpt_7_0"
    _write(path, _state())
    shard = path / "state.npz"
    if damage == "flip":
        # flip one byte inside the stored arrays (past the zip headers): a crc32 no longer matches
        data = bytearray(shard.read_bytes())
        data[len(data) // 2] ^= 0xFF
        shard.write_bytes(bytes(data))
    elif damage == "truncate":
        shard.write_bytes(shard.read_bytes()[:-100])
    elif damage == "manifest":
        (path / "manifest.json").write_text("{not json")
    else:
        os.remove(shard)
    for validate, error in ((jax_validate_checkpoint, JaxCorrupted), (validate_checkpoint, CheckpointCorruptedError)):
        with pytest.raises((error, FileNotFoundError)):
            validate(str(path), deep=True)
    if damage == "flip":
        return  # same sizes: only the deep check (every crc32) sees it, and `latest` runs the quick one
    good = tmp_path / "checkpoint" / "ckpt_3_0"
    _write(good, _state())
    (tmp_path / "checkpoint" / "ckpt_9_0.tmp").mkdir()
    with pytest.warns(UserWarning, match="skipping invalid checkpoint"):
        assert resolve_latest(str(tmp_path)) == str(good)

"""Checkpoint callback (counterpart of ``sheeprl_tpu/utils/callback.py``).

Dispatched via ``fabric.call("on_checkpoint_coupled")``; optionally embeds
the replay-buffer state with the last stored terminal flags forced to 1 so
the in-progress episode terminates cleanly on restore (on ``dones`` and on
the ``terminated`` / ``truncated`` keys). Persistence is the run's
:class:`~sheeprl_tpu_torch.ckpt.manager.CheckpointManager`'s job.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

__all__ = ["CheckpointCallback"]


class CheckpointCallback:
    """Saves ``state`` (a tree of tensors, arrays and counters) and
    optionally the replay buffer. ``keep_last`` overrides the manager's
    ``checkpoint.keep_last`` policy when set."""

    def __init__(self, keep_last: Optional[int] = None):
        self.keep_last = keep_last

    @staticmethod
    def _force_terminal(state: Dict[str, Any]) -> Dict[str, Any]:
        """Force the last stored step of a ReplayBuffer-style state dict to be
        terminal on every termination key present."""
        buf = state.get("buffer")
        if isinstance(buf, dict):
            pos = int(np.asarray(state.get("pos", 0)))
            written = bool(state.get("full", False)) or pos > 0
            for key in ("dones", "terminated", "truncated"):
                if key in buf:
                    arr = np.asarray(buf[key])
                    if arr.size and written:
                        arr = arr.copy()
                        arr[(pos - 1) % arr.shape[0]] = 1
                        buf[key] = arr
        return state

    @staticmethod
    def _buffer_state(rb) -> Dict[str, Any]:
        """Snapshot buffer state with trailing terminal flags forced."""
        state = rb.state_dict()
        if isinstance(state.get("buffers"), list):  # EnvIndependentReplayBuffer
            state["buffers"] = [CheckpointCallback._force_terminal(s) for s in state["buffers"]]
            return state
        return CheckpointCallback._force_terminal(state)

    def on_checkpoint_coupled(self, fabric, ckpt_path: str, state: Dict[str, Any], replay_buffer=None, **_: Any):
        from sheeprl_tpu_torch.ckpt import get_checkpoint_manager

        rb_state = self._buffer_state(replay_buffer) if replay_buffer is not None else None
        get_checkpoint_manager().save(ckpt_path, state, rb_state=rb_state, fabric=fabric, keep_last=self.keep_last)

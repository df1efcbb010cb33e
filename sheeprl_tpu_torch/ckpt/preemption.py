"""Preemption capture: treat SIGTERM/SIGINT as "checkpoint now, then leave"
(counterpart of ``sheeprl_tpu/ckpt/preemption.py``).

Cloud preemption (and most cluster schedulers) delivers SIGTERM with a short
grace window. The handler only sets a flag — Python delivers signals on the
main thread between bytecodes, and the train loop is the one place that
knows the current step state — so the loop's next
:func:`~sheeprl_tpu_torch.ckpt.manager.should_checkpoint` check returns True, the
algorithm writes an immediate final checkpoint, breaks out, and the CLI's
teardown drains the in-flight async save before the process exits cleanly.

A second signal means "actually stop": the original disposition is restored
and the default behavior re-raised, so a hung drain can still be killed
interactively.
"""

from __future__ import annotations

import signal
import threading
from typing import Dict, Optional

__all__ = [
    "install_preemption_handlers",
    "preemption_requested",
    "reset_preemption",
    "uninstall_preemption_handlers",
]

_REQUESTED = threading.Event()
_PREV_HANDLERS: Dict[int, object] = {}


def preemption_requested() -> bool:
    """True once SIGTERM/SIGINT asked the run to checkpoint and exit."""
    return _REQUESTED.is_set()


def reset_preemption() -> None:
    _REQUESTED.clear()


def _handler(signum: int, frame: Optional[object]) -> None:
    if _REQUESTED.is_set():
        # second signal: stop being graceful
        uninstall_preemption_handlers()
        if signum == signal.SIGINT:
            raise KeyboardInterrupt
        raise SystemExit(128 + signum)
    _REQUESTED.set()
    print(
        f"[ckpt] received signal {signum}: requesting a final checkpoint; "
        "the run will save and exit at the next update (signal again to "
        "stop immediately)",
        flush=True,
    )


def install_preemption_handlers(signals=(signal.SIGTERM, signal.SIGINT)) -> bool:
    """Install the capture handlers. Returns False (and stays uninstalled)
    off the main thread — signal.signal is main-thread-only."""
    if threading.current_thread() is not threading.main_thread():
        return False
    for signum in signals:
        if signum in _PREV_HANDLERS:
            continue
        try:
            _PREV_HANDLERS[signum] = signal.signal(signum, _handler)
        except (ValueError, OSError):  # non-main interpreter / exotic platform
            return False
    return True


def uninstall_preemption_handlers() -> None:
    for signum, prev in list(_PREV_HANDLERS.items()):
        try:
            if signal.getsignal(signum) is _handler:
                signal.signal(signum, prev)
        except (ValueError, OSError):
            pass
        _PREV_HANDLERS.pop(signum, None)

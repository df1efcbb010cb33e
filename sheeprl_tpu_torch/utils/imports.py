"""Optional-dependency probes (counterpart of ``sheeprl_tpu/utils/imports.py``,
the port's own copy: same names, same answers).

A module counts as available when it can be found on the path, or when it
is already in ``sys.modules`` with a ``__spec__`` (a simulator module put
there in place of the real package)."""

from __future__ import annotations

import importlib.util
import platform
import sys


def _module_available(name: str) -> bool:
    module = sys.modules.get(name)
    if module is not None and getattr(module, "__spec__", None) is not None:
        return True
    try:
        return importlib.util.find_spec(name) is not None
    except Exception:
        return False


_IS_WINDOWS = platform.system() == "Windows"

_IS_ATARI_AVAILABLE = _module_available("ale_py")
_IS_ATARI_ROMS_AVAILABLE = _IS_ATARI_AVAILABLE
_IS_DMC_AVAILABLE = _module_available("dm_control")
_IS_CRAFTER_AVAILABLE = _module_available("crafter")
_IS_DIAMBRA_AVAILABLE = _module_available("diambra")
_IS_DIAMBRA_ARENA_AVAILABLE = _module_available("diambra.arena")
_IS_MINEDOJO_AVAILABLE = _module_available("minedojo")
_IS_MINERL_AVAILABLE = _module_available("minerl")
_IS_TORCH_AVAILABLE = _module_available("torch")

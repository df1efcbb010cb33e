"""Device resolution: ``cuda`` unless the caller asks for the CPU.

Nothing moves to the CPU quietly: asking for ``cuda`` (or for nothing) on a
machine without a usable GPU raises.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda``. Returns a ``torch.device``; raises when a CUDA
    device is asked for and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: expected 'cuda' or 'cpu'")
    return dev

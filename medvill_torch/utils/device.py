"""Device selection for the entry points: they run on the card unless the
caller asks for the CPU, and never fall back silently."""
from __future__ import annotations

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    """``torch.device(name)``; raises if a CUDA device is asked for on a
    host without one."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but torch sees no "
                           "CUDA device; pass --device cpu to run on the CPU")
    return device

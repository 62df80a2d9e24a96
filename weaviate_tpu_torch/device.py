"""Device resolution for the port's entry points.

Every entry point takes ``device=`` and defaults to the CUDA card. The
CPU is used only when a caller names it (the tests do); asking for the
default on a machine without CUDA raises instead of quietly running on
the CPU.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device=None) -> torch.device:
    """``None`` -> the card; a CUDA device must exist; "cpu" is honoured."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device=\"cpu\" to run on the CPU")
    return dev

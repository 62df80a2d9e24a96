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
    """``None`` -> the card; a CUDA device must exist; "cpu" is honoured.
    A CUDA device comes back with its index (``"cuda"`` is the current
    card), so two names of one card compare equal."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but CUDA is not available; "
                "pass device=\"cpu\" to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


"""Device resolution for the port's entry points.

Entry points run on CUDA unless the caller names another device.  There
is no silent drop to the CPU: asking for CUDA (or nothing) on a machine
without a usable card raises.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; a string or ``torch.device`` is taken as
    given.  Raises ``RuntimeError`` if the result is CUDA and no CUDA
    device is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev

"""Device resolution for the port's entry points.

Entry points run on the current place (``core.place.set_device``), which
is CUDA until a caller sets another, unless the caller names a device.
There is no silent drop to the CPU: asking for CUDA (or nothing, with the
current place on CUDA) on a machine without a usable card raises.
"""
from __future__ import annotations

import torch

from .core import place as _place


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current place (``cuda:0`` unless ``set_device``
    chose another); a string, ``torch.device`` or Place is taken as
    given.  Raises ``RuntimeError`` if the result is CUDA and no CUDA
    device is available."""
    if device is None:
        dev = _place._get_current_place().torch_device()
        if dev.type == "cuda" and dev.index == 0:
            dev = torch.device("cuda")
    elif isinstance(device, _place.Place) or (
            isinstance(device, str)
            and device.split(":")[0].lower() in ("gpu", "tpu", "xpu")):
        dev = _place.to_place(device).torch_device()
    else:
        dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev

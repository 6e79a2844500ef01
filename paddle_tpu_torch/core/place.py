"""Places of the port.

Counterpart of ``paddle_tpu/core/place.py``.  The accelerator here is the
CUDA card: ``CUDAPlace(i)`` is ``torch.device("cuda", i)``, and
``TPUPlace`` and ``XPUPlace`` name the same accelerator (in the
reference ``CUDAPlace`` is an alias of ``TPUPlace``).

Two deliberate differences from the reference:

* the current place starts as ``CUDAPlace(0)`` and never drops to the
  CPU when no card is found (the reference falls back at
  ``place.py:113-117``); a tensor made with no place on a machine without
  a card raises, and ``set_device("cpu")`` or ``place="cpu"`` asks for
  the CPU;
* :func:`is_compiled_with_cuda` is true.
"""
from __future__ import annotations

import torch


class Place:
    """Base place.  Equality is by (kind, device id)."""

    kind = "undefined"

    def __init__(self, device_id: int = 0):
        self._device_id = int(device_id)

    def get_device_id(self) -> int:
        return self._device_id

    def __eq__(self, other):
        return (isinstance(other, Place) and self.kind == other.kind
                and self._device_id == other._device_id)

    def __hash__(self):
        return hash((self.kind, self._device_id))

    def __repr__(self):
        return f"Place({self.kind}:{self._device_id})"

    def torch_device(self) -> torch.device:
        """The torch device of this place."""
        if self.kind == "cpu":
            return torch.device("cpu")
        if self.kind == "gpu":
            return torch.device("cuda", self._device_id)
        raise ValueError(f"no torch device for place {self!r}")


class CPUPlace(Place):
    kind = "cpu"


class CUDAPlace(Place):
    kind = "gpu"


class CustomPlace(Place):
    """Custom-device plugin place; it has no torch device."""

    def __init__(self, dev_type: str, device_id: int = 0):
        super().__init__(device_id)
        self.kind = dev_type


TPUPlace = CUDAPlace
XPUPlace = CUDAPlace
CUDAPinnedPlace = CPUPlace

_current_place: Place = CUDAPlace(0)


def to_place(device) -> Place:
    """A place from a Place, a ``torch.device`` or a name such as
    ``"cpu"``, ``"gpu:1"``, ``"cuda"`` or ``"tpu:0"``."""
    if isinstance(device, Place):
        return device
    if isinstance(device, torch.device):
        if device.type == "cpu":
            return CPUPlace(0)
        if device.type == "cuda":
            return CUDAPlace(device.index or 0)
        return CustomPlace(device.type, device.index or 0)
    name, _, idx = str(device).partition(":")
    idx = int(idx) if idx else 0
    name = name.lower()
    if name == "cpu":
        return CPUPlace(idx)
    if name in ("tpu", "gpu", "xpu", "cuda"):
        return CUDAPlace(idx)
    return CustomPlace(name, idx)


def set_device(device) -> Place:
    """paddle.device.set_device: ``"cpu"``, ``"gpu:0"``, ``"cuda"``,
    ``"tpu"`` or a Place."""
    global _current_place
    _current_place = to_place(device)
    return _current_place


def get_device() -> str:
    p = _current_place
    return f"{p.kind}:{p.get_device_id()}"


def _get_current_place() -> Place:
    return _current_place


def is_compiled_with_cuda() -> bool:
    return True


def is_compiled_with_tpu() -> bool:
    return False


def device_count() -> int:
    """The number of CUDA cards."""
    return torch.cuda.device_count()

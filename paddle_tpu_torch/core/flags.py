"""Runtime flags of the port (``set_flags``, ``get_flags``).  Counterpart
of ``paddle_tpu/core/flags.py``
for the one flag the training path reads so far,
``FLAGS_use_fused_rms_norm`` (default False): with it on,
``nn.functional.rms_norm`` takes the fused RMSNorm kernel
(``ops/kernels/rms_norm.py``) instead of the plain op."""
from __future__ import annotations

_flags = {"FLAGS_use_fused_rms_norm": False}


def _key(name):
    key = name if name.startswith("FLAGS_") else "FLAGS_" + name
    if key not in _flags:
        raise ValueError(f"Unknown flag {name!r}")
    return key


def set_flags(flags: dict) -> None:
    """Set flags by name (with or without the ``FLAGS_`` prefix)."""
    for name, value in flags.items():
        _flags[_key(name)] = bool(value)


def flag(name: str):
    """The value of one flag."""
    return _flags[_key(name)]


def get_flags(flags) -> dict:
    """{name: value} for a flag name or a list of them, keyed as
    given."""
    if isinstance(flags, str):
        flags = [flags]
    return {name: _flags[_key(name)] for name in flags}

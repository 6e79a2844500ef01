"""Runtime flags of the port (``set_flags``, ``get_flags``).  Counterpart
of ``paddle_tpu/core/flags.py``: the same eleven flags with their types
and defaults, each read from a ``FLAGS_*`` environment variable when the
module loads, and kept in its type by ``set_flags`` (a string value is
parsed; ``FLAGS_check_nan_inf_level`` stays an int,
``FLAGS_allocator_strategy`` a string).

What each does here:

* ``FLAGS_check_nan_inf`` (bool): every op that passes the op registry's
  dispatch (``ops/registry.py``) checks its floating outputs and raises
  ``FloatingPointError`` (level 0) or prints (level 1) on a NaN or Inf;
  ``FLAGS_check_nan_inf_level`` (int) picks which.
* ``FLAGS_use_fused_rms_norm`` (bool): ``nn.functional.rms_norm`` and
  ``incubate.nn.functional.fused_rms_norm`` take the fused RMSNorm kernel
  (``ops/kernels/rms_norm.py``).
* Inert on this card, accepted for the reference's scripts:
  ``FLAGS_benchmark``, ``FLAGS_eager_jit_ops`` (the reference's per-op
  executable cache), ``FLAGS_use_bf16_matmul``, ``FLAGS_log_level``,
  ``FLAGS_allocator_strategy`` (torch's caching allocator owns device
  memory), ``FLAGS_embedding_deterministic`` (the port's embedding
  backward is always repeatable, ``nn/common.py``) and
  ``FLAGS_cudnn_deterministic``.
"""
from __future__ import annotations

import os
from typing import Any, Callable


class _Flag:
    __slots__ = ("name", "value", "default", "type", "doc")

    def __init__(self, name, default, type_, doc):
        self.name = name
        self.default = default
        self.type = type_
        self.doc = doc
        env = os.environ.get(name)
        self.value = default if env is None else _parse(env, type_)


def _parse(text: str, type_: Callable):
    if type_ is bool:
        return text.strip().lower() in ("1", "true", "yes", "on")
    return type_(text)


_registry: dict[str, _Flag] = {}
#: {flag name: [callback(value)]} run after ``set_flags`` changes a flag
_watchers: dict[str, list] = {}


def define_flag(name: str, default, doc: str = "", type_=None):
    if not name.startswith("FLAGS_"):
        name = "FLAGS_" + name
    flag_ = _Flag(name, default, type(default) if type_ is None else type_,
                  doc)
    _registry[name] = flag_
    return flag_


def _key(name):
    key = name if name.startswith("FLAGS_") else "FLAGS_" + name
    if key not in _registry:
        raise ValueError(f"Unknown flag {name!r}")
    return key


def get_flags(flags) -> dict[str, Any]:
    """{name: value} for a flag name or a list of them, keyed as given."""
    if isinstance(flags, str):
        flags = [flags]
    return {name: _registry[_key(name)].value for name in flags}


def set_flags(flags: dict):
    """Set flags by name (with or without the ``FLAGS_`` prefix); each
    value is parsed (strings) or converted to the flag's type."""
    for name, value in flags.items():
        f = _registry[_key(name)]
        f.value = _parse(value, f.type) if isinstance(value, str) \
            else f.type(value)
        for cb in _watchers.get(f.name, ()):
            cb(f.value)


def flag(name: str):
    """The value of one flag."""
    return _registry[_key(name)].value


def watch(name: str, callback):
    """Run ``callback(value)`` whenever ``set_flags`` sets ``name``."""
    _watchers.setdefault(_key(name), []).append(callback)


# --- the reference's flag table ---------------------------------------------
define_flag("FLAGS_check_nan_inf", False,
            "Check every op output for NaN/Inf (reference: common/flags.cc:72)")
define_flag("FLAGS_check_nan_inf_level", 0,
            "0: abort on nan/inf; 1: log only (reference: common/flags.cc:86)")
define_flag("FLAGS_benchmark", False, "Inert: benchmark mode")
define_flag("FLAGS_eager_jit_ops", True,
            "Inert: the reference's per-op executable cache")
define_flag("FLAGS_use_bf16_matmul", False, "Inert on this card")
define_flag("FLAGS_log_level", 0, "Inert: framework verbosity")
define_flag("FLAGS_allocator_strategy", "auto_growth",
            "Inert: torch's caching allocator owns device memory")
define_flag("FLAGS_embedding_deterministic", 0,
            "Inert: the embedding backward is always repeatable")
define_flag("FLAGS_cudnn_deterministic", False, "Inert on this card")
define_flag("FLAGS_use_fused_rms_norm", False,
            "Route nn.functional.rms_norm through the fused RMSNorm kernel "
            "(ops/kernels/rms_norm.py) instead of the plain op")

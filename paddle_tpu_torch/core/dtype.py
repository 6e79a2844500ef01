"""Dtype system of the port.

Counterpart of ``paddle_tpu/core/dtype.py``: the paddle-style dtype names
are torch dtypes here (``paddle.float32`` is ``torch.float32``), and
``paddle.dtype`` is ``torch.dtype``.  :func:`dtype_name` gives the same
string as the reference's (``"float32"``, ``"bfloat16"``, ``"bool"``).

``paddle_tpu`` runs with x64 on and computes with ``jax.numpy``'s
promotion, not torch's: an int32 tensor plus a Python float is float64
there, and a sum of int32 is int64.  :func:`result_type` is that lattice
(``jax/_src/dtypes.py`` ``_type_promotion_lattice``, non-strict, x64),
with Python scalars as the weak types ``int``, ``float`` and
``complex``; the op families call it before they call torch.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128
float8_e4m3fn = torch.float8_e4m3fn
float8_e5m2 = torch.float8_e5m2

# paddle.dtype: the type of dtype objects.
dtype = torch.dtype

_STR_TO_DTYPE = {
    "bool": bool_,
    "uint8": uint8,
    "int8": int8,
    "int16": int16,
    "int32": int32,
    "int64": int64,
    "float16": float16,
    "fp16": float16,
    "bfloat16": bfloat16,
    "bf16": bfloat16,
    "float32": float32,
    "fp32": float32,
    "float64": float64,
    "fp64": float64,
    "complex64": complex64,
    "complex128": complex128,
    "float8_e4m3fn": float8_e4m3fn,
    "float8_e5m2": float8_e5m2,
}

_FLOATING = {float16, bfloat16, float32, float64, float8_e4m3fn, float8_e5m2}
_INTEGER = {uint8, int8, int16, int32, int64}
_COMPLEX = {complex64, complex128}


def convert_dtype(dtype):
    """Normalize any dtype spec (a name, a torch dtype, a numpy dtype or
    scalar type, a Python type) to a torch dtype."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        try:
            return _STR_TO_DTYPE[dtype]
        except KeyError:
            raise TypeError(f"Unsupported dtype string: {dtype!r}")
    if dtype is float:
        return float64
    if dtype is int:
        return int64
    if dtype is bool:
        return bool_
    if dtype is complex:
        return complex128
    try:
        name = np.dtype(dtype).name
    except TypeError:
        raise TypeError(f"Cannot convert {dtype!r} to a dtype")
    try:
        return _STR_TO_DTYPE[name]
    except KeyError:
        raise TypeError(f"Cannot convert {dtype!r} to a dtype")


def dtype_name(dtype) -> str:
    """``"float32"``, ``"bfloat16"``, ``"bool"``, ... as ``str`` of the
    reference's numpy dtype gives them."""
    return str(convert_dtype(dtype)).replace("torch.", "")


def is_floating_point(dtype) -> bool:
    return convert_dtype(dtype) in _FLOATING


def is_integer(dtype) -> bool:
    d = convert_dtype(dtype)
    return d in _INTEGER or d == bool_


def is_complex(dtype) -> bool:
    return convert_dtype(dtype) in _COMPLEX


_default_dtype = float32


def set_default_dtype(d):
    global _default_dtype
    d = convert_dtype(d)
    if d not in (float16, bfloat16, float32, float64):
        raise TypeError(
            f"set_default_dtype only supports floating dtypes, got {d}")
    _default_dtype = d


def get_default_dtype():
    return _default_dtype


# -- jax.numpy's promotion -----------------------------------------------------

# The weak types: a Python int, float or complex.
_WI, _WF, _WC = "int*", "float*", "complex*"

_LATTICE = {
    bool_: [_WI],
    _WI: [uint8, int8],
    uint8: [int16],
    int8: [int16],
    int16: [int32],
    int32: [int64],
    int64: [_WF],
    _WF: [float8_e4m3fn, float8_e5m2, bfloat16, float16, _WC],
    float8_e4m3fn: [],
    float8_e5m2: [],
    bfloat16: [float32],
    float16: [float32],
    float32: [float64, complex64],
    float64: [complex128],
    _WC: [complex64],
    complex64: [complex128],
    complex128: [],
}


def _uppers():
    up = {n: {n} for n in _LATTICE}
    changed = True
    while changed:
        changed = False
        for n in _LATTICE:
            new = set().union(*(_LATTICE[b] for b in up[n])) - up[n]
            if new:
                up[n] |= new
                changed = True
    return up


_UPPER = _uppers()
_CANON = {_WI: int64, _WF: float64, _WC: complex128}


@functools.lru_cache(None)
def _join(nodes):
    common = set.intersection(*(_UPPER[n] for n in nodes))
    for c in common:
        if common <= _UPPER[c]:
            return c
    raise TypeError(f"no common dtype for {[str(n) for n in nodes]}")


def _node(x):
    if isinstance(x, torch.Tensor):
        return x.dtype
    if isinstance(x, (np.generic, np.ndarray)):
        return convert_dtype(x.dtype)
    if isinstance(x, bool):
        return bool_
    if isinstance(x, int):
        return _WI
    if isinstance(x, float):
        return _WF
    if isinstance(x, complex):
        return _WC
    if isinstance(x, torch.dtype):
        return x
    raise TypeError(f"no dtype for {type(x).__name__}")


def result_type(*args) -> torch.dtype:
    """The dtype ``jax.numpy`` (x64 on) gives an op over ``args``:
    tensors and numpy values are strongly typed, Python scalars weak."""
    nodes = tuple(dict.fromkeys(_node(a) for a in args))
    r = _join(nodes) if len(nodes) > 1 else nodes[0]
    return _CANON.get(r, r)


_TO_INEXACT = {bool_: float32, uint8: float32, int8: float32,
               int16: float32, int32: float32, int64: float64}


def to_inexact(d) -> torch.dtype:
    """jax's ``to_inexact_dtype``: integers and bool to float32 (int64 to
    float64); inexact dtypes stay."""
    return _TO_INEXACT.get(d, d)


def to_numeric(d) -> torch.dtype:
    """jax's ``to_numeric_dtype``: bool to int32."""
    return int32 if d == bool_ else d

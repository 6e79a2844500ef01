"""Tensor creation ops of the port.

Counterpart of ``paddle_tpu/ops/creation.py``.  A new tensor lies on the
current place (``core.place``: ``cuda:0`` unless ``set_device`` chose
another; with no card that raises), a ``*_like`` tensor on its
argument's device.  Dtypes follow the reference: floats take the
default dtype, ``arange`` over Python ints gives int64, ``full`` of a
bool gives bool.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core.tensor import to_tensor  # noqa: F401
from ..device import resolve_device


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        return tuple(int(v) for v in shape.tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s.item()) if isinstance(s, torch.Tensor) else int(s)
                 for s in shape)


def _dt(dtype, default=None):
    if dtype is None:
        return default or dtype_mod.get_default_dtype()
    return dtype_mod.convert_dtype(dtype)


def _v(v):
    return v.item() if isinstance(v, torch.Tensor) else v


def zeros(shape, dtype=None, name=None):
    return torch.zeros(_shape(shape), dtype=_dt(dtype),
                       device=resolve_device(None))


def ones(shape, dtype=None, name=None):
    return torch.ones(_shape(shape), dtype=_dt(dtype),
                      device=resolve_device(None))


def full(shape, fill_value, dtype=None, name=None):
    fill_value = _v(fill_value)
    if dtype is None:
        dtype = "bool" if isinstance(fill_value, bool) \
            else dtype_mod.get_default_dtype()
    return torch.full(_shape(shape), fill_value, dtype=_dt(dtype),
                      device=resolve_device(None))


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def _like_dtype(x, dtype):
    return dtype_mod.convert_dtype(dtype) if dtype else x.dtype


def zeros_like(x, dtype=None, name=None):
    return torch.zeros_like(x, dtype=_like_dtype(x, dtype))


def ones_like(x, dtype=None, name=None):
    return torch.ones_like(x, dtype=_like_dtype(x, dtype))


def full_like(x, fill_value, dtype=None, name=None):
    return torch.full_like(x, _v(fill_value), dtype=_like_dtype(x, dtype))


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = _v(start), _v(end), _v(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = ("int64" if all(isinstance(v, (int, np.integer))
                                for v in (start, end, step))
                 else dtype_mod.get_default_dtype())
    dt = _dt(dtype)
    dev = resolve_device(None)
    if dt.is_floating_point:
        # jnp.arange counts in float64 and rounds once.
        return torch.arange(start, end, step, dtype=torch.float64,
                            device=dev).to(dt)
    return torch.arange(start, end, step, dtype=dt, device=dev)


def linspace(start, stop, num, dtype=None, name=None):
    dt = _dt(dtype)
    out = torch.linspace(float(_v(start)), float(_v(stop)), int(_v(num)),
                         dtype=torch.float64, device=resolve_device(None))
    return out.to(dt)


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    dt = _dt(dtype)
    exps = torch.linspace(float(_v(start)), float(_v(stop)), int(_v(num)),
                          dtype=torch.float64, device=resolve_device(None))
    return torch.pow(float(_v(base)), exps).to(dt)


def eye(num_rows, num_columns=None, dtype=None, name=None):
    n = int(num_rows)
    return torch.eye(n, int(num_columns) if num_columns else n,
                     dtype=_dt(dtype), device=resolve_device(None))


def diag_embed(input, offset=0, dim1=-2, dim2=-1):  # noqa: A002
    from .math import prep

    (x,) = prep(input)
    return torch.diag_embed(x, offset=int(offset), dim1=dim1, dim2=dim2)


def assign(x, output=None):
    from .manipulation import assign as _assign

    return _assign(x, output)


def clone(x, name=None):
    return assign(x)


def complex(real, imag, name=None):  # noqa: A001
    """``real + 1j * imag`` in the complex dtype of their promotion."""
    from .math import prep

    r, i = prep(real, imag)
    ct = torch.complex128 if r.dtype == torch.float64 else torch.complex64
    return torch.complex(r.to(ct.to_real()), i.to(ct.to_real()))


def as_complex(x, name=None):
    """[..., 2] real pairs as complex values."""
    from .math import prep

    (x,) = prep(x)
    return torch.complex(x[..., 0], x[..., 1])


def as_real(x, name=None):
    from .math import prep

    (x,) = prep(x)
    return torch.stack([x.real, x.imag], dim=-1)

"""Reduction ops of the port.

Counterpart of ``paddle_tpu/ops/reduction.py``, with Paddle's
conventions: ``axis`` is ``None`` (all axes), an int or a list, and
``keepdim`` keeps the reduced axes.  ``max`` / ``min`` return values only
(torch's ``max(dim)`` returns a pair) and split a tie's gradient evenly,
as the reference's backward does; ``median`` averages the two middle
values of an even count (torch's takes the lower); ``cumsum`` without an
axis runs over the flattened tensor.  Result dtypes are ``jax.numpy``'s:
a sum of a narrower integer (or bool) is int64, a mean of one is float
(``core.dtype.to_inexact``).
"""
from __future__ import annotations

import builtins as _bi
import math

import torch

from ..core import dtype as D
from .math import prep


def _axes(axis, ndim):
    """``axis`` as a tuple of non-negative dims, or ``None`` for all."""
    if axis is None:
        return None
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) % _bi.max(ndim, 1) for a in axis)
    return (int(axis) % _bi.max(ndim, 1),)


def _dims(x, axis):
    ax = _axes(axis, x.dim())
    return tuple(range(x.dim())) if ax is None else ax


def _count(x, axis):
    return math.prod(x.shape[d] for d in _dims(x, axis)) if x.dim() else 1


def _sum_dtype(d):
    if d == torch.bool or d in (torch.int8, torch.int16, torch.int32):
        return torch.int64
    return d


def _cast(out, dtype):
    if dtype is None:
        return out
    return out.to(D.convert_dtype(dtype))


def sum(x, axis=None, dtype=None, keepdim=False, name=None):  # noqa: A001
    (x,) = prep(x)
    dims = _dims(x, axis)
    out = torch.sum(x.to(_sum_dtype(x.dtype)), dim=dims, keepdim=keepdim) \
        if x.dim() else x.to(_sum_dtype(x.dtype)).clone()
    return _cast(out, dtype)


def mean(x, axis=None, keepdim=False, name=None):
    (x,) = prep(x)
    x = x.to(D.to_inexact(x.dtype))
    if x.dim() == 0:
        return x.clone()
    return torch.mean(x, dim=_dims(x, axis), keepdim=keepdim)


def _amax(x, axis, keepdim, fn):
    (x,) = prep(x)
    if x.dim() == 0:
        return x.clone()
    if x.dtype == torch.bool:
        red = torch.any if fn is torch.amax else torch.all
        out = x
        for d in sorted(_dims(x, axis), reverse=True):
            out = red(out, dim=d, keepdim=keepdim)
        return out
    return fn(x, dim=_dims(x, axis), keepdim=keepdim)


def max(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return _amax(x, axis, keepdim, torch.amax)


def min(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return _amax(x, axis, keepdim, torch.amin)


amax = max
amin = min


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    (x,) = prep(x)
    out = x.to(_sum_dtype(x.dtype))
    if out.dim():
        for d in sorted(_dims(x, axis), reverse=True):
            out = torch.prod(out, dim=d, keepdim=keepdim)
    else:
        out = out.clone()
    return _cast(out, dtype)


def _logical(x, axis, keepdim, fn):
    (x,) = prep(x)
    out = x.to(torch.bool)
    if out.dim() == 0:
        return out.clone()
    for d in sorted(_dims(x, axis), reverse=True):
        out = fn(out, dim=d, keepdim=keepdim)
    return out


def any(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return _logical(x, axis, keepdim, torch.any)


def all(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return _logical(x, axis, keepdim, torch.all)


def logsumexp(x, axis=None, keepdim=False, name=None):
    (x,) = prep(x)
    x = x.to(D.to_inexact(x.dtype))
    if x.dim() == 0:
        return x.clone()
    return torch.logsumexp(x, dim=_dims(x, axis), keepdim=keepdim)


def _arg(x, axis, keepdim, dtype, fn):
    (x,) = prep(x)
    if axis is None:
        out = fn(x.reshape(-1), dim=0)
        if keepdim:
            out = out.reshape([1] * x.dim())
    else:
        out = fn(x, dim=int(axis), keepdim=keepdim)
    return out.to(D.convert_dtype(dtype))


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(x, axis, keepdim, dtype, torch.argmax)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(x, axis, keepdim, dtype, torch.argmin)


def _scan_dtype(d):
    return torch.int64 if d == torch.bool else d


def cumsum(x, axis=None, dtype=None, name=None):
    """Running sum along ``axis`` (over the flattened tensor when
    ``None``) in x's dtype (bool counts in int64), as ``jnp.cumsum``."""
    (x,) = prep(x)
    if axis is None:
        x, axis = x.reshape(-1), 0
    out = torch.cumsum(x, dim=int(axis), dtype=_scan_dtype(x.dtype))
    return _cast(out, dtype)


def cumprod(x, dim=None, dtype=None, name=None):
    (x,) = prep(x)
    if dim is None:
        x, dim = x.reshape(-1), 0
    out = torch.cumprod(x, dim=int(dim), dtype=_scan_dtype(x.dtype))
    return _cast(out, dtype)


def _cum_ext(x, axis, fn):
    (x,) = prep(x)
    if axis is None:
        x, axis = x.reshape(-1), 0
    vals, idx = fn(x, dim=int(axis))
    return vals, idx.to(torch.int64)


def cummax(x, axis=None, dtype="int64", name=None):
    """Running max and the index of its last occurrence so far."""
    return _cum_ext(x, axis, torch.cummax)


def cummin(x, axis=None, dtype="int64", name=None):
    return _cum_ext(x, axis, torch.cummin)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    """``mean((x - mean(x))**2)``, scaled by n / (n - 1) when
    ``unbiased``, as the reference composes it."""
    from . import math as m_ops

    m = mean(x, axis=axis, keepdim=True)
    d = m_ops.subtract(x, m)
    out = mean(m_ops.multiply(d, d), axis=axis, keepdim=keepdim)
    n = _count(prep(x)[0], axis)
    if unbiased and n > 1:
        out = m_ops.scale(out, scale=n / (n - 1))
    return out


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    from . import math as m_ops

    return m_ops.sqrt(var(x, axis=axis, unbiased=unbiased, keepdim=keepdim))


def numel(x, name=None):
    """The element count as a 0-d int64 tensor on x's device."""
    return torch.tensor(x.numel(), dtype=torch.int64, device=x.device)


def count_nonzero(x, axis=None, keepdim=False, name=None):
    (x,) = prep(x)
    return sum((x != 0).to(torch.int64), axis=axis, keepdim=keepdim)


def nanmean(x, axis=None, keepdim=False, name=None):
    (x,) = prep(x)
    x = x.to(D.to_inexact(x.dtype))
    if x.dim() == 0:
        return x.clone()
    return torch.nanmean(x, dim=_dims(x, axis), keepdim=keepdim)


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    (x,) = prep(x)
    if not x.is_floating_point():
        return sum(x, axis=axis, keepdim=keepdim)
    if x.dim() == 0:
        return torch.nan_to_num(x, nan=0.0)
    return torch.nansum(x, dim=_dims(x, axis), keepdim=keepdim)


def _moved(x, axis):
    """x with the reduced axes moved to the end and flattened into one,
    and the shape a keepdim result takes."""
    dims = _dims(x, axis)
    rest = [d for d in range(x.dim()) if d not in dims]
    keep = [1 if d in dims else x.shape[d] for d in range(x.dim())]
    xm = x.permute(rest + list(dims)).reshape(
        [x.shape[d] for d in rest] + [-1])
    return xm, keep


def median(x, axis=None, keepdim=False, mode="avg", name=None):
    """``jnp.median``: the mean of the two middle values of an even
    count; NaN where the slice holds a NaN."""
    return _quantile(x, 0.5, axis, keepdim, midpoint=True)


def quantile(x, q, axis=None, keepdim=False, name=None):
    """``jnp.quantile`` with linear interpolation between the sorted
    values at ``q * (n - 1)``."""
    return _quantile(x, q, axis, keepdim, midpoint=False)


def _quantile(x, q, axis, keepdim, midpoint):
    (x,) = prep(x)
    x = x.to(D.to_inexact(x.dtype))
    if x.dim() == 0:
        xm, keep = x.reshape(1), None
    else:
        xm, keep = _moved(x, axis)
    n = xm.shape[-1]
    s = torch.sort(xm, dim=-1).values
    pos = float(q) * (n - 1)
    lo = int(math.floor(pos))
    hi = _bi.min(int(math.ceil(pos)), n - 1)
    if midpoint:
        v = (s[..., lo] + s[..., hi]) * 0.5
    else:
        frac = pos - lo
        v = s[..., lo] * (1 - frac) + s[..., hi] * frac
    # jnp.quantile: NaN where the slice holds a NaN
    v = torch.where(torch.isnan(xm).any(dim=-1),
                    torch.full_like(v, float("nan")), v)
    return v.reshape(keep) if keepdim and keep is not None else v

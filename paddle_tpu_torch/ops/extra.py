"""Long-tail tensor ops of the port: the math, search, statistics and
manipulation tail.

Counterpart of ``paddle_tpu/ops/extra.py``.  Each op is registered by
the reference's name and dispatched with the reference's operands and
attrs (:func:`_simple`), so the InferMeta validators, the AMP policy,
the NaN/Inf check and the operator statistics see it as the reference's
registry does; gradients come from torch's autograd over the plain
torch expression.  Where torch's function rounds or breaks ties
differently from ``jax.numpy`` the reference's formula is written out
(``renorm``, ``cdist``, ``nanmedian``, ``mode``, ``logit``).
"""
from __future__ import annotations

import numpy as np
import torch

from .manipulation import _t
from .registry import apply, register_op


def _axis_t(axis):
    if axis is None:
        return None
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _simple(name, fn):
    """The op ``name`` over ``fn``: positional arguments are its
    operands, keyword arguments its attrs (the reference's
    ``_simple``)."""
    op = register_op(name, fn)

    def call(*args, **kwargs):
        kwargs.pop("name", None)
        return apply(op, *args, **kwargs)

    call.__name__ = name
    return call


# -- math tail ----------------------------------------------------------

kron = _simple("kron", lambda x, y: torch.kron(_t(x), _t(y)))
trace = _simple(
    "trace",
    lambda x, offset=0, axis1=0, axis2=1: torch.diagonal(
        x, offset, axis1, axis2).sum(-1))
heaviside = _simple("heaviside", lambda x, y: torch.heaviside(
    *torch.broadcast_tensors(x, _t(y).to(x.dtype))))
copysign = _simple("copysign", lambda x, y: torch.copysign(x, _t(y)))
ldexp = _simple("ldexp", lambda x, y: torch.ldexp(
    x, _t(y).to(torch.int32)).to(x.dtype if x.is_floating_point()
                                 else torch.float64))
hypot = _simple("hypot", lambda x, y: torch.hypot(x, _t(y)))
deg2rad = _simple("deg2rad", torch.deg2rad)
rad2deg = _simple("rad2deg", torch.rad2deg)
diff = _simple("diff", lambda x, n=1, axis=-1: torch.diff(x, n=n,
                                                           dim=axis))


def _trapezoid(y, x=None, dx=1.0, axis=-1):
    if x is not None:
        return torch.trapezoid(y, x=_t(x), dim=axis)
    return torch.trapezoid(y, dx=dx, dim=axis)


trapezoid = _simple("trapezoid", _trapezoid)
def _vander(x, n=None, increasing=False):
    # x ** k column by column (torch.vander's backward writes in place)
    n = x.shape[0] if n is None else int(n)
    k = torch.arange(n, device=x.device)
    return x[:, None] ** (k if increasing else k.flip(0))


vander = _simple("vander", _vander)
logcumsumexp = _simple(
    "logcumsumexp",
    lambda x, axis=-1: torch.logcumsumexp(x, dim=axis % max(x.dim(), 1)))


def _renorm_impl(x, p, axis, max_norm):
    """tensor/math.py renorm: each sub-tensor along ``axis`` whose
    p-norm exceeds max_norm is scaled down to max_norm."""
    axes = tuple(i for i in range(x.dim()) if i != axis % x.dim())
    norms = (x.abs() ** p).sum(dim=axes, keepdim=True) ** (1.0 / p)
    scale = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                        torch.ones_like(norms))
    return x * scale


renorm = _simple("renorm", lambda x, p, axis, max_norm: _renorm_impl(
    x, p, axis, max_norm))


def _cdist_impl(x, y, p):
    d = (x[..., :, None, :] - y[..., None, :, :]).abs()
    if p == 2.0:
        return torch.sqrt(torch.clamp((d * d).sum(-1), min=0.0))
    if p == float("inf"):
        return d.amax(-1)
    return (d ** p).sum(-1) ** (1.0 / p)


cdist = _simple("cdist", lambda x, y, p=2.0: _cdist_impl(x, _t(y), p))
_tensordot_op = register_op(
    "tensordot",
    lambda x, y, axes=2: torch.tensordot(
        x, y, dims=[list(a) for a in axes] if isinstance(axes, tuple)
        else axes))


def tensordot(x, y, axes=2, name=None):
    if isinstance(axes, torch.Tensor):
        axes = axes.tolist()
    if isinstance(axes, (list, tuple)):
        axes = tuple(tuple(int(i) for i in a)
                     if isinstance(a, (list, tuple)) else int(a)
                     for a in axes)
        if all(isinstance(a, int) for a in axes):
            axes = (axes, axes)
    else:
        axes = int(axes)
    return apply(_tensordot_op, x, _t(y), axes=axes)


# -- search / stat tail -------------------------------------------------

bucketize = _simple(
    "bucketize",
    lambda x, sorted_sequence, out_int32=False, right=False:
        torch.bucketize(x, sorted_sequence, out_int32=out_int32,
                        right=right))
searchsorted = _simple(
    "searchsorted",
    lambda sorted_sequence, values, out_int32=False, right=False:
        torch.searchsorted(sorted_sequence, values, out_int32=out_int32,
                           right=right))


def _to_last(x, axis):
    """x with the axes in ``axis`` (None: all) moved last and flattened
    into one: (tensor, the reduced axes in x's numbering)."""
    axes = tuple(range(x.dim())) if axis is None else (
        (axis,) if isinstance(axis, int) else tuple(axis))
    axes = tuple(a % max(x.dim(), 1) for a in axes)
    keep = [a for a in range(x.dim()) if a not in axes]
    xm = x.permute(keep + list(axes))
    return xm.reshape(xm.shape[:len(keep)] + (-1,)), axes


def _keepdims(out, x, axes):
    shape = [1 if a in axes else s for a, s in enumerate(x.shape)]
    return out.reshape(shape)


def _nanmedian_impl(x, axis, keepdim):
    """``jnp.nanmedian``: the mean of the two middle non-NaN values (NaN
    where a slice has none)."""
    xm, axes = _to_last(x, axis)
    s = torch.sort(xm, dim=-1).values          # NaN sorts last
    cnt = (~torch.isnan(xm)).sum(-1, keepdim=True)
    lo = torch.clamp((cnt - 1) // 2, min=0)
    hi = torch.clamp(cnt // 2, min=0)
    med = (s.gather(-1, lo) + s.gather(-1, hi)) / 2
    med = torch.where(cnt > 0, med, torch.full_like(med, float("nan")))
    med = med[..., 0]
    return _keepdims(med, x, axes) if keepdim else med


nanmedian = _simple(
    "nanmedian",
    lambda x, axis=None, keepdim=False: _nanmedian_impl(
        x, _axis_t(axis), keepdim))


def _mode_impl(x, axis):
    """tensor/search.py mode: the most frequent value (ties: the larger
    value) and the first index holding it."""
    xm = x.movedim(axis, -1)
    n = xm.shape[-1]
    s = torch.sort(xm, dim=-1).values
    eq = torch.cat([torch.ones_like(s[..., :1], dtype=torch.bool),
                    s[..., 1:] == s[..., :-1]], dim=-1)
    run_id = torch.cumsum((~eq).long(), dim=-1)
    flat = run_id.reshape(-1, n)
    cnt = torch.zeros_like(flat).scatter_add_(1, flat,
                                              torch.ones_like(flat))
    run_cnt = cnt.gather(1, flat).reshape(run_id.shape)
    best = torch.argmax(run_cnt.double() + run_id.double() * 1e-6, dim=-1)
    vals = s.gather(-1, best[..., None])[..., 0]
    idx = torch.argmax((xm == vals[..., None]).to(torch.uint8), dim=-1)
    return vals, idx


_mode_op = register_op("mode", lambda x, axis: _mode_impl(x, axis),
                       n_outputs=2)


def mode(x, axis=-1, keepdim=False, name=None):
    vals, idx = apply(_mode_op, x, axis=int(axis))
    if keepdim:
        return vals.unsqueeze(axis), idx.unsqueeze(axis)
    return vals, idx


def _kthvalue_impl(x, k, axis):
    s, i = torch.sort(x.movedim(axis, -1), dim=-1, stable=True)
    return s[..., k - 1], i[..., k - 1]


_kthvalue_op = register_op("kthvalue", _kthvalue_impl, n_outputs=2)


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    vals, idx = apply(_kthvalue_op, x, k=int(k), axis=int(axis))
    if keepdim:
        return vals.unsqueeze(axis), idx.unsqueeze(axis)
    return vals, idx


# -- manipulation tail --------------------------------------------------

_rot90_op = register_op(
    "rot90", lambda x, k=1, axes=(0, 1): torch.rot90(x, k, list(axes)))


def rot90(x, k=1, axes=(0, 1), name=None):
    return apply(_rot90_op, x, k=int(k), axes=tuple(int(a) for a in axes))


def _take_impl(x, index, mode="raise"):
    flat = x.reshape(-1)
    n = flat.shape[0]
    index = index.long()
    if mode == "raise":
        index = torch.where(index < 0, index + n, index)
        index = index.clamp(0, n - 1)
    elif mode == "wrap":
        index = torch.remainder(index, n)
    else:
        index = index.clamp(0, n - 1)
    return flat[index]


_take_op = register_op("take", _take_impl)


def take(x, index, mode="raise", name=None):
    """tensor/math.py take.  ``mode='raise'`` checks the bounds (a read
    of the index to the host, as the reference's eager check)."""
    if mode == "raise":
        size = x.numel()
        idx = index if isinstance(index, torch.Tensor) else \
            torch.as_tensor(np.asarray(index))
        if idx.numel() and (int(idx.min()) < -size
                            or int(idx.max()) >= size):
            raise IndexError(
                f"take: index out of range for tensor of {size} "
                f"elements (got [{int(idx.min())}, {int(idx.max())}])")
    return apply(_take_op, x, _t(index), mode=str(mode))


# Positional order matches the reference signatures
# index_add(x, index, axis, value) / index_fill(x, index, axis, value).
index_add = _simple(
    "index_add",
    lambda x, index, axis, value: torch.index_add(
        x, axis, index.long(), _t(value).to(x.dtype)))
index_fill = _simple(
    "index_fill",
    lambda x, index, axis, value: torch.index_fill(
        x, axis, index.long(), value))

_unfold_op = register_op(
    "tensor_unfold",
    lambda x, axis, size, step: x.unfold(axis, size, step))


def unfold(x, axis, size, step, name=None):
    return apply(_unfold_op, x, axis=int(axis), size=int(size),
                 step=int(step))


_as_strided_op = register_op(
    "as_strided",
    lambda x, shape, stride, offset=0: torch.as_strided(
        x.contiguous().reshape(-1), shape, stride, offset).clone())


def as_strided(x, shape, stride, offset=0, name=None):
    return apply(_as_strided_op, x, shape=tuple(int(s) for s in shape),
                 stride=tuple(int(s) for s in stride), offset=int(offset))


_select_scatter_op = register_op(
    "select_scatter",
    lambda x, value, axis, index: torch.select_scatter(
        x, value.to(x.dtype), axis, index))


def select_scatter(x, value, axis, index, name=None):
    return apply(_select_scatter_op, x, _t(value), axis=int(axis),
                 index=int(index))


def _slice_scatter_impl(x, value, axes, starts, ends, strides):
    idx = [slice(None)] * x.dim()
    for a, s, e, st in zip(axes, starts, ends, strides):
        idx[a] = slice(s, e, st)
    out = x.clone()
    out[tuple(idx)] = value.to(x.dtype)
    return out


_slice_scatter_op = register_op("slice_scatter", _slice_scatter_impl)


def slice_scatter(x, value, axes, starts, ends, strides, name=None):
    return apply(_slice_scatter_op, x, _t(value),
                 axes=tuple(int(a) for a in axes),
                 starts=tuple(int(s) for s in starts),
                 ends=tuple(int(e) for e in ends),
                 strides=tuple(int(s) for s in strides))


# -- stack / split family (compositions) --------------------------------

def atleast_1d(*inputs):
    outs = [x if x.dim() >= 1 else x.reshape(1) for x in map(_t, inputs)]
    return outs if len(outs) > 1 else outs[0]


def atleast_2d(*inputs):
    outs = []
    for x in map(_t, inputs):
        if x.dim() == 0:
            outs.append(x.reshape(1, 1))
        elif x.dim() == 1:
            outs.append(x.reshape(1, x.shape[0]))
        else:
            outs.append(x)
    return outs if len(outs) > 1 else outs[0]


def atleast_3d(*inputs):
    outs = []
    for x in map(_t, inputs):
        if x.dim() == 0:
            outs.append(x.reshape(1, 1, 1))
        elif x.dim() == 1:
            outs.append(x.reshape(1, x.shape[0], 1))
        elif x.dim() == 2:
            outs.append(x.reshape(*x.shape, 1))
        else:
            outs.append(x)
    return outs if len(outs) > 1 else outs[0]


def column_stack(x, name=None):
    from .manipulation import concat

    return concat([c.reshape(c.shape[0], 1) if c.dim() == 1 else c
                   for c in map(_t, x)], axis=1)


def row_stack(x, name=None):
    from .manipulation import concat

    return concat([atleast_2d(c) for c in map(_t, x)], axis=0)


def dstack(x, name=None):
    from .manipulation import concat

    return concat([atleast_3d(c) for c in map(_t, x)], axis=2)


def tensor_split(x, num_or_indices, axis=0, name=None):
    from .manipulation import slice as _slice

    x = _t(x)
    axis = int(axis) % x.dim()
    n = x.shape[axis]
    if isinstance(num_or_indices, int):
        base, extra = divmod(n, num_or_indices)
        bounds = [0]
        for i in range(num_or_indices):
            bounds.append(bounds[-1] + base + (1 if i < extra else 0))
    else:
        bounds = [0] + [int(i) for i in num_or_indices] + [n]
    return [_slice(x, [axis], [bounds[i]], [bounds[i + 1]])
            for i in range(len(bounds) - 1)]


def hsplit(x, num_or_indices, name=None):
    x = _t(x)
    return tensor_split(x, num_or_indices, axis=0 if x.dim() == 1 else 1)


def vsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=0)


def dsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=2)


_diagflat_op = register_op(
    "diagflat", lambda x, offset=0: torch.diagflat(x, offset))


def diagflat(x, offset=0, name=None):
    return apply(_diagflat_op, x, offset=int(offset))


def _index_put_impl(x, value, *indices, accumulate):
    idx = tuple(i if i.dtype == torch.bool else i.long() for i in indices)
    if len(idx) == 1 and idx[0].dtype == torch.bool:
        suffix = x.shape[idx[0].dim():]
        if value.dim() > len(suffix) and value.shape[0] == 1:
            value = value.reshape(value.shape[1:])
    return torch.index_put(x, idx, value.to(x.dtype), accumulate)


_index_put_op = register_op(
    "index_put",
    lambda x, value, *indices, accumulate=False: _index_put_impl(
        x, value, *indices, accumulate=accumulate))


def index_put(x, indices, value, accumulate=False, name=None):
    """``x[indices] = value`` as a new tensor (reference
    python/paddle/tensor/manipulation.py:6659)."""
    return apply(_index_put_op, x, _t(value), *tuple(indices),
                 accumulate=bool(accumulate))


def index_put_(x, indices, value, accumulate=False, name=None):
    from .inplace import _needs_grad, rebind

    tracked = _needs_grad((x, value))
    out = index_put(x.clone() if tracked else x, indices, value, accumulate)
    return rebind(x, out, tracked)

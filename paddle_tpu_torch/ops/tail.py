"""The op long tail of the port, second part: complex and elementwise
odds, special functions, construction, indexing, statistics and the
linalg tail (Householder products, ``frexp``, the bit shifts).

Counterpart of ``paddle_tpu/ops/tail.py``; each op is registered by the
reference's name and dispatched as ``ops/extra.py`` dispatches its ops.
Where torch's function differs from ``jax.numpy``'s the reference's
formula is written out (``logit``, ``multigammaln``, ``pdist``,
``cartesian_prod``, ``strided_slice`` with negative strides).
"""
from __future__ import annotations

import math as _math

import torch

from .extra import _simple, _to_last
from .manipulation import _t
from .registry import apply, register_op


# -- complex / elementwise tail ---------------------------------------------

real = _simple("real", torch.real)
imag = _simple("imag", lambda x: torch.imag(x) if x.is_complex()
               else torch.zeros_like(x))
conj = _simple("conj", lambda x: torch.conj(x).resolve_conj())
angle = _simple("angle", torch.angle)
isreal = _simple("isreal", torch.isreal)
isneginf = _simple("isneginf", torch.isneginf)
isposinf = _simple("isposinf", torch.isposinf)
signbit = _simple("signbit", torch.signbit)
sinc = _simple("sinc", torch.sinc)
nextafter = _simple("nextafter", lambda x, y: torch.nextafter(x, _t(y)))
polar = _simple("polar", lambda abs, angle: torch.polar(abs, _t(angle)))
sgn = _simple("sgn", torch.sgn)


def _logit(x, eps=None):
    if eps is not None:
        x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x) - torch.log1p(-x)


logit = _simple("logit", _logit)
round = _simple("round", lambda x, decimals=0: torch.round(  # noqa: A001
    x, decimals=int(decimals)))

# -- special functions -------------------------------------------------------

gammaln = _simple("gammaln", torch.lgamma)
gammainc = _simple("gammainc", lambda x, y: torch.special.gammainc(
    x, _t(y)))
gammaincc = _simple("gammaincc", lambda x, y: torch.special.gammaincc(
    x, _t(y)))


def _multigammaln(x, p):
    i = torch.arange(1, p + 1, dtype=x.dtype, device=x.device)
    return (p * (p - 1) / 4.0 * _math.log(_math.pi)
            + torch.lgamma(x[..., None] + (1 - i) / 2.0).sum(-1))


multigammaln = _simple("multigammaln", _multigammaln)
i0e = _simple("i0e", torch.special.i0e)
i1 = _simple("i1", torch.special.i1)
i1e = _simple("i1e", torch.special.i1e)
polygamma = _simple("polygamma", lambda x, n: torch.polygamma(int(n), x))

# -- construction / manipulation tail ---------------------------------------

_hstack_op = register_op("hstack", lambda *xs: torch.hstack(xs))
_vstack_op = register_op("vstack", lambda *xs: torch.vstack(xs))
_block_diag_op = register_op(
    "block_diag",
    lambda *xs: torch.block_diag(*[x if x.dim() >= 2 else x.reshape(1, -1)
                                   for x in xs]))
_add_n_op = register_op("add_n", lambda *xs: sum(xs[1:], xs[0]))
_cartesian_prod_op = register_op(
    "cartesian_prod",
    lambda *xs: torch.stack([g.reshape(-1) for g in torch.meshgrid(
        *xs, indexing="ij")], -1))


def hstack(x, name=None):
    return apply(_hstack_op, *x)


def vstack(x, name=None):
    return apply(_vstack_op, *x)


def block_diag(inputs, name=None):
    return apply(_block_diag_op, *inputs)


def add_n(inputs, name=None):
    if not isinstance(inputs, (list, tuple)):
        return inputs
    return apply(_add_n_op, *inputs)


def cartesian_prod(x, name=None):
    return apply(_cartesian_prod_op, *x)


def _combinations_impl(x, r, with_replacement):
    if x.shape[0] == 0 or r > x.shape[0] and not with_replacement:
        return x.new_zeros((0, r))
    return torch.combinations(x, r, with_replacement)


combinations = _simple(
    "combinations",
    lambda x, r=2, with_replacement=False: _combinations_impl(
        x, r, with_replacement))
reverse = _simple("reverse", lambda x, axis: torch.flip(
    x, [axis] if isinstance(axis, int) else list(axis)))


def _crop(x, shape=None, offsets=None):
    shape = list(x.shape) if shape is None else list(shape)
    offsets = [0] * x.dim() if offsets is None else list(offsets)
    shape = [x.shape[i] - offsets[i] if s == -1 else s
             for i, s in enumerate(shape)]
    return x[tuple(slice(o, o + s) for o, s in zip(offsets, shape))]


_crop_op = register_op("crop", _crop)


def crop(x, shape=None, offsets=None, name=None):
    return apply(_crop_op, x,
                 shape=None if shape is None else tuple(shape),
                 offsets=None if offsets is None else tuple(offsets))


unflatten = _simple("unflatten", lambda x, axis, shape: torch.unflatten(
    x, axis, tuple(shape)))


def view_as(x, other):
    """reference manipulation.view_as: reshape to other's shape."""
    from .manipulation import reshape

    return reshape(x, list(other.shape))


def _strided_slice(x, axes, starts, ends, strides):
    """``x[s:e:st]`` on each axis, negative strides included (torch's
    slicing takes none: the indices are gathered)."""
    for ax, s, e, st in zip(axes, starts, ends, strides):
        if st > 0:
            idx = [slice(None)] * x.dim()
            idx[ax] = slice(s, e, st)
            x = x[tuple(idx)]
        else:
            rows = range(*slice(s, e, st).indices(x.shape[ax]))
            x = x.index_select(ax, torch.tensor(list(rows), dtype=torch.long,
                                                device=x.device))
    return x


_strided_slice_op = register_op("strided_slice", _strided_slice)


def strided_slice(x, axes, starts, ends, strides, name=None):
    return apply(_strided_slice_op, x, axes=tuple(axes),
                 starts=tuple(starts), ends=tuple(ends),
                 strides=tuple(strides))


def _scatter_nd(index, updates, shape):
    # duplicate indices accumulate, as the reference kernel's
    out = updates.new_zeros(tuple(shape))
    idx = tuple(index.long().movedim(-1, 0))
    return out.index_put(idx, updates, accumulate=True)


scatter_nd = _simple("scatter_nd", _scatter_nd)
diagonal_scatter = _simple(
    "diagonal_scatter",
    lambda x, y, offset=0, axis1=0, axis2=1: torch.diagonal_scatter(
        x, _t(y).to(x.dtype), offset, axis1, axis2))
masked_scatter = _simple(
    "masked_scatter",
    lambda x, mask, value: torch.masked_scatter(
        x, mask.broadcast_to(x.shape), _t(value).to(x.dtype)))
index_sample = _simple("index_sample", lambda x, index: torch.gather(
    x, 1, index.long()))


def _multiplex(index, *inputs):
    stacked = torch.stack(inputs, 0)
    idx = index.reshape(-1).long()
    return stacked[idx, torch.arange(stacked.shape[1],
                                     device=stacked.device)]


_multiplex_op = register_op("multiplex", _multiplex)


def multiplex(inputs, index, name=None):
    """Row b of the output is ``inputs[index[b]][b]``."""
    return apply(_multiplex_op, index, *inputs)


def _shard_index(x, index_num, nshards, shard_id, ignore_value):
    shard_size = (index_num + nshards - 1) // nshards
    lo = shard_id * shard_size
    inside = (x >= lo) & (x < lo + shard_size)
    return torch.where(inside, x - lo, torch.full_like(x, ignore_value))


shard_index = _simple(
    "shard_index",
    lambda x, index_num, nshards, shard_id, ignore_value=-1: _shard_index(
        x, index_num, nshards, shard_id, ignore_value))


def _reduce_as(x, target_shape):
    extra = x.dim() - len(target_shape)
    axes = list(range(extra))
    for i, t in enumerate(target_shape):
        if x.shape[extra + i] != t:
            axes.append(extra + i)
    out = x.sum(dim=tuple(axes), keepdim=True) if axes else x
    return out.reshape(target_shape)


_reduce_as_op = register_op("reduce_as", _reduce_as)


def reduce_as(x, target, name=None):
    """Sum x down to target's shape."""
    return apply(_reduce_as_op, x,
                 target_shape=tuple(int(d) for d in target.shape))


isin = _simple(
    "isin",
    lambda x, test_x, assume_unique=False, invert=False: torch.isin(
        x, _t(test_x), invert=invert))


def _tri_indices(fn):
    def impl(row, col=None, offset=0):
        from ..device import resolve_device

        return fn(row, row if col is None else col, offset,
                  device=resolve_device(None))
    return impl


tril_indices = _simple("tril_indices", _tri_indices(torch.tril_indices))
triu_indices = _simple("triu_indices", _tri_indices(torch.triu_indices))


def shape(x):
    """The runtime shape as an int32 tensor (on x's device)."""
    return torch.tensor(list(x.shape), dtype=torch.int32, device=x.device)


def is_empty(x):
    return torch.tensor(x.numel() == 0, device=x.device)


def is_integer(x):
    return not x.is_floating_point() and not x.is_complex() \
        and x.dtype != torch.bool


# -- stat tail ---------------------------------------------------------------

def _nanquantile(x, q, axis=None, keepdim=False):
    xm, axes = _to_last(x, axis)
    qs = torch.tensor(q, dtype=x.dtype, device=x.device) \
        if isinstance(q, (list, tuple)) else float(q)
    out = torch.nanquantile(xm, qs, dim=-1)
    if keepdim:
        shape = [1 if a in axes else s for a, s in enumerate(x.shape)]
        out = out.reshape(out.shape[:out.dim() - len(x.shape) + len(axes)]
                          + tuple(shape)) if isinstance(qs, float) else \
            out.reshape((len(q),) + tuple(shape))
    return out


nanquantile = _simple("nanquantile", _nanquantile)


def _pdist(x, p):
    n = x.shape[-2]
    i, j = torch.triu_indices(n, n, 1, device=x.device)
    d = x[..., i, :] - x[..., j, :]
    if p == 2.0:
        return torch.sqrt((d * d).sum(-1) + 1e-30)
    if p == float("inf"):
        return d.abs().amax(-1)
    return (d.abs() ** p).sum(-1) ** (1.0 / p)


pdist = _simple("pdist", lambda x, p=2.0: _pdist(x, p))


def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    """``(hist, edges)`` of the rows of ``x [N, D]`` (``np.histogramdd``'s
    bins: half-open but the last, which holds its right edge), on x's
    device."""
    N, D = x.shape
    xd = x.double() if x.dtype != torch.float64 else x
    if isinstance(bins, (list, tuple)) and len(bins) and \
            hasattr(bins[0], "__len__"):
        edges = [torch.as_tensor(b, dtype=torch.float64, device=x.device)
                 for b in bins]
    else:
        nb = list(bins) if isinstance(bins, (list, tuple)) else [bins] * D
        edges = []
        for d in range(D):
            if ranges is not None:
                lo, hi = float(ranges[2 * d]), float(ranges[2 * d + 1])
            else:
                lo, hi = float(xd[:, d].min()), float(xd[:, d].max())
            if lo == hi:
                lo, hi = lo - 0.5, hi + 0.5
            edges.append(torch.linspace(lo, hi, int(nb[d]) + 1,
                                        dtype=torch.float64,
                                        device=x.device))
    flat = torch.zeros(N, dtype=torch.long, device=x.device)
    inside = torch.ones(N, dtype=torch.bool, device=x.device)
    sizes = [e.numel() - 1 for e in edges]
    for d, e in enumerate(edges):
        col = xd[:, d].contiguous()
        k = torch.searchsorted(e, col, right=True) - 1
        k = torch.where(col == e[-1], torch.full_like(k, sizes[d] - 1), k)
        inside &= (k >= 0) & (k < sizes[d])
        flat = flat * sizes[d] + k.clamp(0, sizes[d] - 1)
    w = torch.ones(N, dtype=torch.float64, device=x.device) \
        if weights is None else weights.double()
    w = torch.where(inside, w, torch.zeros_like(w))
    hist = torch.bincount(flat, weights=w, minlength=int(
        torch.tensor(sizes).prod())).reshape(sizes)
    if density:
        vol = torch.ones(sizes, dtype=torch.float64, device=x.device)
        for d, e in enumerate(edges):
            shp = [1] * D
            shp[d] = sizes[d]
            vol = vol * (e[1:] - e[:-1]).reshape(shp)
        hist = hist / (hist.sum() * vol)
    out_dt = x.dtype if x.is_floating_point() else torch.float64
    if weights is None and not density:
        return hist.to(torch.int64), [e.to(out_dt) for e in edges]
    return hist.to(out_dt), [e.to(out_dt) for e in edges]


def _cumulative_trapezoid(y, x=None, dx=1.0, axis=-1):
    if x is not None:
        return torch.cumulative_trapezoid(y, x=_t(x), dim=axis)
    return torch.cumulative_trapezoid(y, dx=dx, dim=axis)


cumulative_trapezoid = _simple("cumulative_trapezoid", _cumulative_trapezoid)

# -- linalg tail -------------------------------------------------------------

mv = _simple("mv", lambda x, vec: torch.matmul(x, _t(vec)))
vecdot = _simple("vecdot", lambda x, y, axis=-1: (
    torch.conj(x) * _t(y)).sum(axis))
householder_product = _simple(
    "householder_product",
    lambda x, tau: torch.linalg.householder_product(x, tau))
_geqrf_op = register_op("geqrf", torch.geqrf, n_outputs=2)


def geqrf(x, name=None):
    """Householder QR factors (a, tau), LAPACK-packed."""
    return tuple(apply(_geqrf_op, x))


ormqr = _simple(
    "ormqr",
    lambda x, tau, other, left=True, transpose=False: torch.ormqr(
        x, tau, other, left, transpose))
cholesky_inverse = _simple(
    "cholesky_inverse",
    lambda x, upper=False: torch.cholesky_inverse(x, upper=upper))


def _frexp(x):
    m, e = torch.frexp(x)
    return m, e.to(torch.int32)


_frexp_op = register_op("frexp", _frexp, n_outputs=2)


def frexp(x, name=None):
    """(mantissa, exponent)."""
    return apply(_frexp_op, x)


def _logical_rshift(a, b):
    bits = a.element_size() * 8
    b = b.to(a.dtype)
    shifted = torch.bitwise_right_shift(a, b)
    one = torch.ones_like(a)
    mask = torch.bitwise_left_shift(one, torch.clamp(bits - b, max=bits - 1)
                                    ) - 1
    mask = torch.where(b == 0, torch.full_like(a, -1), mask)
    mask = torch.where(b >= bits, torch.zeros_like(a), mask)
    return shifted & mask


_logical_rshift_op = register_op("bitwise_right_shift_logical",
                                 _logical_rshift)


def bitwise_left_shift(x, y, is_arithmetic=True, name=None):
    """Left shift (the same in arithmetic and logical modes)."""
    from .math import left_shift

    return left_shift(x, y)


def bitwise_right_shift(x, y, is_arithmetic=True, name=None):
    """Right shift; ``is_arithmetic=False`` fills with zeros."""
    from .math import right_shift

    if is_arithmetic:
        return right_shift(x, y)
    return apply(_logical_rshift_op, x, _t(y))

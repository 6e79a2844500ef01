"""N-dimensional convolutions and pools.  Counterpart of
``paddle_tpu/ops/nn_ops_nd.py``: ``conv1d_transpose``, ``conv3d``,
``conv3d_transpose``, the 1-d / 3-d (and generic 2-d) max and average
pools with ``ceil_mode``, ``exclusive`` and ``divisor_override``, the
Lp pools, the adaptive pools, max pooling with indices and its unpool,
and fractional max pooling.  Channel-first layouts throughout (NCL,
NCHW, NCDHW).

Every op of the reference here is ``lax.conv_general_dilated`` or
``lax.reduce_window`` (XLA, no Pallas kernel), so the convolutions are
the library's (cuDNN on the card, through ``nn_ops._Conv``: TF32 held
off for fp32 as for ``conv2d``) and the pools plain PyTorch with the
reference's window rules.  Each op carries the reference's registered
name for the AMP policy (``registry.dispatch``).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .registry import dispatch
from .nn_ops import _Conv


def _tup(v, n):
    if isinstance(v, (list, tuple)):
        if len(v) != n:
            raise ValueError(f"expected {n} values, got {v}")
        return tuple(int(x) for x in v)
    return (int(v),) * n


# -- conv tail ---------------------------------------------------------------

@dispatch("conv1d_transpose")
def conv1d_transpose(x, weight, stride=1, padding=0, output_padding=0,
                     dilation=1, groups=1):
    """``[N, C, L]`` by an IOL weight ``[in, out / groups, k]`` cast to
    x's dtype; output ``(L - 1) * stride - 2 * padding + dilation * (k -
    1) + output_padding + 1``."""
    return _Conv.apply(x, weight.to(x.dtype), _tup(stride, 1),
                       _tup(padding, 1), _tup(dilation, 1), int(groups),
                       True, _tup(output_padding, 1))


@dispatch("conv3d")
def conv3d(x, weight, stride=1, padding=0, dilation=1, groups=1):
    """``[N, C, D, H, W]`` by an OIDHW weight cast to x's dtype."""
    return _Conv.apply(x, weight.to(x.dtype), _tup(stride, 3),
                       _tup(padding, 3), _tup(dilation, 3), int(groups))


@dispatch("conv3d_transpose")
def conv3d_transpose(x, weight, stride=1, padding=0, output_padding=0,
                     dilation=1, groups=1):
    """``[N, C, D, H, W]`` by an IODHW weight ``[in, out / groups, kd, kh,
    kw]`` cast to x's dtype (the transposed convolution of
    ``conv2d_transpose`` in three dimensions)."""
    return _Conv.apply(x, weight.to(x.dtype), _tup(stride, 3),
                       _tup(padding, 3), _tup(dilation, 3), int(groups),
                       True, _tup(output_padding, 3))


# -- generic channel-first pooling ------------------------------------------

def _ceil_extension(L, k, s, p):
    """High-side padding extension for ceil_mode, with the reference
    rule that a window starting entirely inside the right padding is
    dropped: extend only while the extra window's start < L."""
    rem = (L + 2 * p - k) % s
    if rem == 0:
        return 0
    floor_out = (L + 2 * p - k) // s + 1
    if floor_out * s - p >= L:
        return 0
    return s - rem


def _pads(lo_hi):
    """``F.pad``'s flat list (last axis first) from per-axis (lo, hi)."""
    return [v for lo, hi in reversed(lo_hi) for v in (lo, hi)]


def _window_sum(x, k, s):
    """The sum over each window (no padding), as ``reduce_window(add)``;
    through the library's average pool with a divisor of 1."""
    nd = len(k)
    if nd == 1:
        return F.avg_pool2d(x[..., None, :], (1, k[0]), (1, s[0]),
                            divisor_override=1)[..., 0, :]
    if nd == 2:
        return F.avg_pool2d(x, k, s, divisor_override=1)
    return F.avg_pool3d(x, k, s, divisor_override=1)


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def pool_nd(x, kernel, stride, padding, op, exclusive=True, ceil_mode=False,
            divisor_override=None):
    """``_pool_nd``: max or average over ``len(kernel)`` trailing axes.
    ``ceil_mode`` extends the high side by ``_ceil_extension``; max pads
    with -inf; average sums the zero-padded input (the extension
    included) and divides by ``divisor_override``, or by the count of
    real elements (``exclusive``), or by the count of real and declared
    padding elements, never the extension."""
    nd = len(kernel)
    extra = [_ceil_extension(x.shape[2 + i], kernel[i], stride[i],
                             padding[i]) if ceil_mode else 0
             for i in range(nd)]
    if op == "max":
        pads = _pads([(p, p + e) for p, e in zip(padding, extra)])
        if any(pads):
            x = F.pad(x, pads, value=float("-inf"))
        return _MAX_POOL[nd](x, kernel, stride)
    if divisor_override is None and not any(padding) and not any(extra):
        return _window_sum(x, kernel, stride) / float(math.prod(kernel))
    declared = _pads([(p, p) for p in padding])
    ext = _pads([(0, e) for e in extra])
    summed = _window_sum(F.pad(F.pad(x, declared), ext), kernel, stride)
    if divisor_override is not None:
        return summed / float(divisor_override)
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    mask = F.pad(ones, declared) if exclusive else F.pad(ones, declared,
                                                         value=1.0)
    return summed / _window_sum(F.pad(mask, ext), kernel, stride)


def _named_pool(name, nd, op):
    @dispatch(name)
    def pool(x, kernel_size, stride, padding, ceil_mode=False,
             exclusive=True, divisor_override=None):
        return pool_nd(x, _tup(kernel_size, nd), _tup(stride, nd),
                       _tup(padding, nd), op, exclusive, ceil_mode,
                       divisor_override)

    pool.__name__ = pool.__qualname__ = name
    pool.__doc__ = (f"``{name}_op``: :func:`pool_nd` over {nd} axes "
                    f"({op}).")
    return pool


max_pool1d = _named_pool("max_pool1d", 1, "max")
max_pool3d = _named_pool("max_pool3d", 3, "max")
avg_pool1d = _named_pool("avg_pool1d", 1, "avg")
avg_pool3d = _named_pool("avg_pool3d", 3, "avg")
avg_pool2d_g = _named_pool("avg_pool2d_g", 2, "avg")


def _lp_pool(x, kernel_size, stride, padding, norm_type):
    """``_lp_pool_nd``: ``(sum |x|^p)^(1/p)`` over each zero-padded
    window; ``p = inf`` is the max of ``|x|`` (padding at -inf)."""
    nd = len(kernel_size)
    pads = _pads([(p, p) for p in padding])
    if norm_type == float("inf"):
        return _MAX_POOL[nd](F.pad(x.abs(), pads, value=float("-inf")),
                             kernel_size, stride)
    s = _window_sum(F.pad(x.abs() ** norm_type, pads), kernel_size, stride)
    return s ** (1.0 / norm_type)


@dispatch("lp_pool1d")
def lp_pool1d(x, kernel_size, stride, padding, norm_type):
    return _lp_pool(x, _tup(kernel_size, 1), _tup(stride, 1),
                    _tup(padding, 1), float(norm_type))


@dispatch("lp_pool2d")
def lp_pool2d(x, kernel_size, stride, padding, norm_type):
    return _lp_pool(x, _tup(kernel_size, 2), _tup(stride, 2),
                    _tup(padding, 2), float(norm_type))


# -- adaptive pooling --------------------------------------------------------
# ``_adaptive_regions``: region i of an axis is [floor(i * in / out),
# ceil((i + 1) * in / out)), the library's own adaptive rule.

@dispatch("adaptive_avg_pool1d")
def adaptive_avg_pool1d(x, output_size):
    return F.adaptive_avg_pool1d(x, _tup(output_size, 1))


@dispatch("adaptive_avg_pool3d")
def adaptive_avg_pool3d(x, output_size):
    return F.adaptive_avg_pool3d(x, _tup(output_size, 3))


@dispatch("adaptive_max_pool1d")
def adaptive_max_pool1d(x, output_size):
    return F.adaptive_max_pool1d(x, _tup(output_size, 1))


@dispatch("adaptive_max_pool2d")
def adaptive_max_pool2d(x, output_size):
    return F.adaptive_max_pool2d(x, _tup(output_size, 2))


@dispatch("adaptive_max_pool3d")
def adaptive_max_pool3d(x, output_size):
    return F.adaptive_max_pool3d(x, _tup(output_size, 3))


# -- max pooling with indices + unpool --------------------------------------

def _max_with_index_windows(x, k, s, p):
    """Max pooling with indices for any padding: the windows of the
    -inf-padded input (``Tensor.unfold`` per axis), the first maximum of
    each (the lowest flat index among ties, as the reference's reducer
    takes it) and its flat index over the input's spatial axes; a window
    wholly in padding gives -inf at index ``prod(spatial)``."""
    nd = len(k)
    spatial = tuple(x.shape[2:])
    flat = math.prod(spatial)
    pads = _pads([(q, q) for q in p])
    idx = F.pad(torch.arange(flat, device=x.device, dtype=torch.float64)
                .reshape((1, 1) + spatial), pads, value=float(flat))
    xw = F.pad(x, pads, value=float("-inf"))
    for d in range(nd):
        xw = xw.unfold(2 + d, k[d], s[d])
        idx = idx.unfold(2 + d, k[d], s[d])
    xw = xw.flatten(-nd)
    arg = xw.argmax(-1, keepdim=True)
    idx = idx.flatten(-nd).expand(xw.shape).gather(-1, arg)
    return xw.gather(-1, arg)[..., 0], idx[..., 0].long()


@dispatch("max_pool_with_index")
def max_pool_with_index(x, kernel_size, stride, padding):
    """``max_pool_with_index_op``: (the max of each window, its flat index
    over the input's spatial axes, int64).  The first maximum in window
    order wins ties, on the library's pool (padding up to half the
    window) and on :func:`_max_with_index_windows` (any padding) alike;
    the gradient goes to that element (the reference's backward
    scatter-adds there)."""
    nd = x.dim() - 2
    k, s, p = _tup(kernel_size, nd), _tup(stride, nd), _tup(padding, nd)
    if all(q <= kk // 2 for q, kk in zip(p, k)):
        return _MAX_POOL[nd](x, k, s, p, return_indices=True)
    return _max_with_index_windows(x, k, s, p)


class _MaxUnpool(torch.autograd.Function):
    """``max_unpool_op`` with the reference's forward and backward: an
    index outside the output is dropped by the scatter (XLA's scatter
    drops it), and the backward gathers the cotangent at each index
    clamped into the output (XLA's gather clamps)."""

    @staticmethod
    def forward(ctx, x, indices, out_spatial):
        N, C = x.shape[:2]
        flat = math.prod(out_spatial)
        idx = indices.reshape(N, C, -1).long()
        ctx.save_for_backward(idx)
        ctx.shape = x.shape
        at = torch.where((idx >= 0) & (idx < flat), idx, flat)
        out = x.new_zeros((N, C, flat + 1)).scatter(2, at, x.reshape(N, C,
                                                                     -1))
        return out[..., :flat].reshape((N, C) + tuple(out_spatial))

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        gf = g.reshape(idx.shape[0], idx.shape[1], -1)
        dx = gf.gather(2, idx.clamp(0, gf.shape[2] - 1))
        return dx.reshape(ctx.shape), None, None


@dispatch("max_unpool")
def max_unpool(x, indices, out_spatial):
    """``_max_unpool_nd``: each pooled value written at its flat index of
    a zero ``[N, C, *out_spatial]`` (see :class:`_MaxUnpool`)."""
    return _MaxUnpool.apply(x, indices, tuple(int(v) for v in out_spatial))


# -- fractional max pooling --------------------------------------------------

def _fractional_regions(in_size, out_size, u):
    """Pseudo-random region boundaries (reference
    fractional_max_pool: alpha = in/out, b_i = ceil(alpha*(i+u)))."""
    alpha = in_size / out_size
    idx = np.arange(out_size + 1, dtype=np.float64)
    bounds = np.ceil(alpha * (idx + u)).astype(np.int64) - \
        int(np.ceil(alpha * u))
    bounds = np.clip(bounds, 0, in_size)
    bounds[-1] = in_size
    return bounds


@dispatch("fractional_max_pool")
def fractional_max_pool(x, output_size, us):
    """``_fractional_max_pool_nd``: one axis at a time, region i the
    input's ``[b_i, max(b_{i+1}, b_i + 1))`` (clipped to the axis), its
    max.  Each axis is one gather: a region shorter than the longest
    repeats its last element, which leaves its max as it is."""
    nd = x.dim() - 2
    out = x
    for axis in range(nd):
        in_size, n = out.shape[2 + axis], int(output_size[axis])
        b = _fractional_regions(in_size, n, us[axis])
        start = b[:-1]
        end = np.minimum(np.maximum(b[1:], start + 1), in_size)
        span = int((end - start).max())
        cols = np.minimum(start[:, None] + np.arange(span)[None, :],
                          end[:, None] - 1).clip(0, in_size - 1)
        idx = torch.as_tensor(cols.reshape(-1), device=x.device)
        out = out.index_select(2 + axis, idx).unflatten(
            2 + axis, (n, span)).amax(3 + axis)
    return out

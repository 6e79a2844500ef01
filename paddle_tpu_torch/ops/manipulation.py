"""Shape, layout and indexing ops of the port.

Counterpart of ``paddle_tpu/ops/manipulation.py``, with Paddle's meaning
where torch's differs: ``transpose(x, perm)`` permutes every axis,
``flatten(x, start_axis, stop_axis)``, ``gather`` / ``index_select`` take
rows along ``axis`` (torch's ``gather`` is :func:`take_along_axis`),
``scatter`` writes rows at ``index``, ``split(x, num_or_sections)``
counts pieces (torch's counts a piece's size), ``squeeze(axis)`` leaves
an axis of size other than 1, ``expand`` keeps -1 axes, ``slice`` takes
``(axes, starts, ends)``, ``unique`` runs on the host with numpy as the
reference's does, and ``unstack`` returns a list.  ``concat``, ``stack``,
``where`` and ``masked_fill`` promote as ``jax.numpy`` does.

``topk`` breaks ties lowest index first, as the reference's ``_topk``
does (one stable sort on the key, negated for ``largest``).
"""
from __future__ import annotations

import builtins

import numpy as np
import torch
import torch.nn.functional as F

from ..core import dtype as D
from .math import prep

builtins_slice = builtins.slice


def _ints(v):
    if isinstance(v, torch.Tensor):
        v = v.tolist()
    if isinstance(v, (list, tuple)):
        return [int(s.item()) if isinstance(s, torch.Tensor) else int(s)
                for s in v]
    return int(v)


def _t(x):
    (x,) = prep(x)
    return x


# -- cast -------------------------------------------------------------------

def cast(x, dtype):
    return _t(x).to(D.convert_dtype(dtype))


# -- reshape family ---------------------------------------------------------

def reshape(x, shape, name=None):
    return torch.reshape(_t(x), _ints(shape))


def transpose(x, perm, name=None):
    """Permute every axis: ``perm[i]`` is the input axis of output axis
    ``i`` (torch's ``transpose`` swaps two)."""
    return _t(x).permute(_ints(perm))


def t(x, name=None):
    x = _t(x)
    if x.dim() < 2:
        return assign(x)
    return transpose(x, list(range(x.dim() - 2)) + [x.dim() - 1,
                                                      x.dim() - 2])


def squeeze(x, axis=None, name=None):
    """Drop the axes of size 1 among ``axis`` (all of them when
    ``None``); an axis of another size stays."""
    x = _t(x)
    if axis is None:
        return torch.squeeze(x)
    axes = _ints(axis)
    axes = axes if isinstance(axes, list) else [axes]
    axes = [a % x.dim() for a in axes]
    axes = [a for a in axes if x.shape[a] == 1]
    if not axes:
        return assign(x)
    return torch.squeeze(x, dim=tuple(axes))


def unsqueeze(x, axis, name=None):
    """Insert axes of size 1 at ``axis`` (positions in the output, as
    ``jnp.expand_dims``)."""
    x = _t(x)
    axes = _ints(axis)
    axes = axes if isinstance(axes, list) else [axes]
    nd = x.dim() + len(axes)
    for a in sorted(a % nd for a in axes):
        x = x.unsqueeze(a)
    return x


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    x = _t(x)
    if x.dim() == 0:
        return reshape(x, [1])
    return torch.flatten(x, start_axis % x.dim(), stop_axis % x.dim())


def expand(x, shape, name=None):
    """Broadcast to ``shape``; a -1 keeps the input's axis."""
    x = _t(x)
    shape = _ints(shape)
    lead = len(shape) - x.dim()
    shape = [x.shape[i - lead] if s == -1 else s for i, s in enumerate(shape)]
    return torch.broadcast_to(x, shape)


broadcast_to = expand


def expand_as(x, y, name=None):
    return expand(x, list(y.shape))


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def tile(x, repeat_times, name=None):
    return torch.tile(_t(x), tuple(_ints(repeat_times)))


# -- concat / split / stack -------------------------------------------------

def concat(x, axis=0, name=None):
    return torch.cat(prep(*x), dim=_ints(axis))


def stack(x, axis=0, name=None):
    return torch.stack(prep(*x), dim=int(axis))


def split(x, num_or_sections, axis=0, name=None):
    """``num_or_sections``: the number of equal pieces (the axis must
    divide), or the list of piece sizes with at most one -1."""
    x = _t(x)
    axis = _ints(axis) % x.dim()
    dim = x.shape[axis]
    if isinstance(num_or_sections, int):
        if dim % num_or_sections:
            raise ValueError(
                f"split: axis {axis} of size {dim} does not divide into "
                f"{num_or_sections} equal pieces")
        sections = [dim // num_or_sections] * num_or_sections
    else:
        sections = _ints(num_or_sections)
        known = builtins.sum(s for s in sections if s != -1)
        sections = [dim - known if s == -1 else s for s in sections]
    return list(torch.split(x, sections, dim=axis))


def chunk(x, chunks, axis=0, name=None):
    return split(x, int(chunks), axis)


def unstack(x, axis=0, num=None, name=None):
    x = _t(x)
    return list(torch.unbind(x, dim=int(axis) % x.dim()))


def unbind(x, axis=0):
    return unstack(x, axis)


# -- flip / roll / pad ------------------------------------------------------

def flip(x, axis, name=None):
    axes = _ints(axis)
    return torch.flip(_t(x), axes if isinstance(axes, list) else [axes])


def roll(x, shifts, axis=None, name=None):
    shifts = _ints(shifts)
    axis = _ints(axis) if axis is not None else None
    return torch.roll(_t(x), shifts, axis)


_PAD_MODES = {"constant": "constant", "reflect": "reflect",
              "replicate": "edge", "circular": "wrap"}


def pad(x, pad, mode="constant", value=0.0, data_format=None, name=None):
    """nn.functional.pad with an int list: one (before, after) pair per
    axis when it covers every axis, else pairs for the trailing axes,
    the last axis first."""
    x = _t(x)
    nd = x.dim()
    pad = _ints(pad)
    if len(pad) == 2 * nd:
        pairs = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        pairs = [(0, 0)] * nd
        for i in range(len(pad) // 2):
            pairs[nd - 1 - i] = (pad[2 * i], pad[2 * i + 1])
    npmode = _PAD_MODES[mode]
    if npmode == "constant":
        flat = []
        for lo, hi in reversed(pairs):
            flat += [lo, hi]
        return F.pad(x, flat, mode="constant", value=float(value))
    for d, (lo, hi) in enumerate(pairs):
        if lo or hi:
            idx = np.pad(np.arange(x.shape[d]), (lo, hi), mode=npmode)
            x = x.index_select(d, torch.as_tensor(idx, device=x.device))
    return x


# -- gather / scatter / index ops ------------------------------------------

def _long(index, device):
    if not isinstance(index, torch.Tensor):
        index = torch.as_tensor(np.asarray(index))
    return index.to(device=device, dtype=torch.int64)


def gather(x, index, axis=0, name=None):
    """Rows of ``x`` along ``axis`` at ``index`` (flattened to 1-D);
    ``index_select`` is the same op."""
    x = _t(x)
    axis = _ints(axis) % x.dim()
    index = _long(index, x.device)
    if index.dim() == 0:
        return x.select(axis, index)
    return torch.index_select(x, axis, index.reshape(-1))


index_select = gather


def _along(x, index, axis):
    """x and index broadcast against each other on every axis but
    ``axis`` (``jnp.take_along_axis``'s rule)."""
    shape_x, shape_i = list(x.shape), list(index.shape)
    for d in range(x.dim()):
        if d == axis:
            continue
        n = builtins.max(shape_x[d], shape_i[d])
        shape_x[d] = shape_i[d] = n
    return x.expand(shape_x), index.expand(shape_i)


def take_along_axis(x, indices, axis, broadcast=True, name=None):
    x = _t(x)
    axis = int(axis) % x.dim()
    x, index = _along(x, _long(indices, x.device), axis)
    return torch.gather(x, axis, index)


def put_along_axis(x, indices, values, axis, reduce="assign",
                   include_self=True, broadcast=True, name=None):
    x, values = prep(x, values, dtype=_t(x).dtype)
    axis = int(axis) % x.dim()
    index = _long(indices, x.device)
    if not isinstance(values, torch.Tensor):
        values = torch.full(index.shape, values, dtype=x.dtype,
                            device=x.device)
    values = values.expand(index.shape)
    if reduce == "assign":
        return x.scatter(axis, index, values)
    if reduce == "add":
        return x.scatter_add(axis, index, values)
    if reduce in ("multiply", "mul"):
        return x.scatter_reduce(axis, index, values, "prod")
    raise ValueError(f"unsupported reduce {reduce}")


def scatter(x, index, updates, overwrite=True, name=None):
    """Write the rows of ``updates`` at rows ``index`` of x
    (``overwrite``), or add them to x's rows."""
    x, updates = prep(x, updates, dtype=_t(x).dtype)
    index = _long(index, x.device)
    if overwrite:
        return x.index_put((index,), updates)
    return x.index_put((index,), updates, accumulate=True)


def scatter_nd_add(x, index, updates, name=None):
    x, updates = prep(x, updates, dtype=_t(x).dtype)
    index = _long(index, x.device)
    return x.index_put(tuple(index.unbind(-1)), updates, accumulate=True)


def gather_nd(x, index, name=None):
    x = _t(x)
    index = _long(index, x.device)
    return x[tuple(index.unbind(-1))]


# -- where / masked ---------------------------------------------------------

def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    a, b = prep(x, y)
    cond = _t(condition).to(torch.bool)
    a = a if isinstance(a, torch.Tensor) else torch.tensor(
        a, dtype=b.dtype, device=b.device)
    b = b if isinstance(b, torch.Tensor) else torch.tensor(
        b, dtype=a.dtype, device=a.device)
    return torch.where(cond.to(a.device), a, b)


def nonzero(x, as_tuple=False):
    """[n, ndim] int64 indices of the nonzero entries; with
    ``as_tuple`` one [n, 1] tensor per axis, as the reference gives."""
    nz = torch.nonzero(_t(x))
    if as_tuple:
        return tuple(nz[:, d:d + 1] for d in range(nz.shape[1]))
    return nz


def masked_select(x, mask, name=None):
    x = _t(x)
    return torch.masked_select(x, _t(mask).to(torch.bool))


def masked_fill(x, mask, value, name=None):
    a, v = prep(x, value)
    mask = _t(mask).to(torch.bool)
    if not isinstance(v, torch.Tensor):
        return torch.where(mask, torch.tensor(v, dtype=a.dtype,
                                              device=a.device), a)
    return torch.where(mask, v, a)


# -- sort / topk / unique ---------------------------------------------------

def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    """``(values, indices int64)`` of the ``k`` largest (or smallest)
    entries along ``axis``, as ``_topk`` computes them: one stable sort on
    the key (negated for ``largest``), so the lowest index comes first
    among equal values.  ``torch.topk`` promises no order among ties on
    CUDA, and bf16 gate probabilities tie often."""
    x = _t(x)
    k = int(k.item()) if isinstance(k, torch.Tensor) else int(k)
    xm = x.movedim(axis, -1)
    keys = -xm if largest else xm
    sk, si = torch.sort(keys, dim=-1, stable=True)
    vals = -sk[..., :k] if largest else sk[..., :k]
    return vals.movedim(-1, axis), si[..., :k].movedim(-1, axis)


def sort(x, axis=-1, descending=False, stable=False, name=None):
    """The sorted values only (torch's ``sort`` returns a pair)."""
    return torch.sort(_t(x), dim=int(axis), descending=bool(descending),
                      stable=True).values


def argsort(x, axis=-1, descending=False, stable=False, name=None):
    """Stable: equal values keep their order, descending too (the
    reference sorts the negated key)."""
    return torch.argsort(_t(x), dim=int(axis), descending=bool(descending),
                         stable=True)


def _host(x):
    """x as a numpy array (bf16 through float32, which holds it
    exactly) and the dtype to return values in."""
    x = _t(x)
    dt = x.dtype
    y = x.detach()
    if dt in (torch.bfloat16, torch.float16):
        y = y.float()
    return y.cpu().numpy(), dt, x.device


def _back(arr, dt, dev):
    return torch.as_tensor(np.ascontiguousarray(arr)).to(device=dev, dtype=dt)


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """``np.unique`` on the host, as the reference computes it."""
    arr, dt, dev = _host(x)
    res = np.unique(arr, return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    if not isinstance(res, tuple):
        return _back(res, dt, dev)
    return (_back(res[0], dt, dev),) + tuple(
        torch.as_tensor(r).to(dev) for r in res[1:])


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    """The reference's host computation, line for line."""
    arr, dt, dev = _host(x)
    if arr.ndim == 0 or arr.size == 0:
        return _back(arr, dt, dev)
    flat = arr.reshape(-1) if axis is None else arr
    keep = np.concatenate([[True], flat[1:] != flat[:-1]]) \
        if axis is None else None
    results = [_back(flat[keep], dt, dev)]
    if return_inverse:
        inv = np.cumsum(keep) - 1
        results.append(torch.as_tensor(inv.astype(np.int64)).to(dev))
    if return_counts:
        idx = np.flatnonzero(keep)
        counts = np.diff(np.append(idx, flat.size))
        results.append(torch.as_tensor(counts.astype(np.int64)).to(dev))
    return results[0] if len(results) == 1 else tuple(results)


# -- misc -------------------------------------------------------------------

def assign(x, output=None):
    """A differentiable copy of ``x``; with ``output``, written into it
    (in output's dtype)."""
    if not isinstance(x, torch.Tensor):
        from ..core.tensor import numpy_to_torch
        from ..device import resolve_device

        x = numpy_to_torch(np.asarray(x)).to(resolve_device(None))
    out = x.clone()
    if output is not None:
        with torch.no_grad():
            output.copy_(out)
        return output
    return out


def tril(x, diagonal=0, name=None):
    return torch.tril(_t(x), int(diagonal))


def triu(x, diagonal=0, name=None):
    return torch.triu(_t(x), int(diagonal))


def diag(x, offset=0, padding_value=0, name=None):
    return torch.diag(_t(x), int(offset))


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(_t(x), int(offset), int(axis1), int(axis2))


def repeat_interleave(x, repeats, axis=None, name=None):
    x = _t(x)
    if isinstance(repeats, (list, tuple)):
        repeats = torch.as_tensor(repeats)
    if isinstance(repeats, torch.Tensor):
        repeats = repeats.to(device=x.device, dtype=torch.int64)
    return torch.repeat_interleave(
        x, repeats, dim=int(axis) if axis is not None else None)


def one_hot(x, num_classes, name=None):
    return F.one_hot(_t(x).to(torch.int64),
                     int(num_classes)).to(torch.float32)


def meshgrid(*args, **kwargs):
    """``ij``-indexed grids, each in its input's dtype."""
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = args[0]
    xs = [_t(a).reshape(-1) for a in args]
    shape = [a.numel() for a in xs]
    out = []
    for i, a in enumerate(xs):
        view = [1] * len(xs)
        view[i] = -1
        out.append(a.reshape(view).expand(shape).clone())
    return out


def moveaxis(x, source, destination, name=None):
    return torch.movedim(_t(x), _ints(source), _ints(destination))


def view(x, shape_or_dtype, name=None):
    """A list reshapes; a dtype casts (values, not bits)."""
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    return cast(x, shape_or_dtype)


def slice(x, axes, starts, ends):  # noqa: A001 - paddle API name
    """``x[starts[i]:ends[i]]`` on each of ``axes``, clamped to the
    axis as Python slicing clamps."""
    x = _t(x)
    idx = [builtins_slice(None)] * x.dim()
    for ax, s, e in zip(_ints(axes), _ints(starts), _ints(ends)):
        idx[ax] = builtins_slice(s, e)
    return x[tuple(idx)]


def _index(idx):
    if not isinstance(idx, tuple):
        idx = (idx,)
    return tuple(torch.as_tensor(np.asarray(i)) if isinstance(
        i, (list, np.ndarray)) else i for i in idx)


def getitem(x, idx):
    return _t(x)[_index(idx)]


def setitem(x, idx, value):
    """``x[idx] = value`` in x's dtype; returns x."""
    if isinstance(value, torch.Tensor):
        value = value.to(device=x.device, dtype=x.dtype)
    x[_index(idx)] = value
    return x


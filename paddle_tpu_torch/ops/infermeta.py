"""Eager argument validation: the InferMeta layer of the port.

Counterpart of ``paddle_tpu/ops/infermeta.py`` (the reference's
``paddle/phi/infermeta/``): the same 105 validators with the same
``InvalidArgument`` messages.  The op registry's dispatch
(``ops/registry.py``) runs the validator of an op's name on the call's
metadata only: each tensor becomes a :class:`Meta` (shape, dtype name,
rank), so a validator never reads a value on the device and never
synchronises, and a CUDA graph capture passes through it.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.enforce import InvalidArgumentError


class Meta:
    """What a validator sees of a tensor: ``shape`` (a tuple), ``dtype``
    (the dtype's name, as ``str`` of a ``jax.numpy`` dtype gives it) and
    ``ndim``."""

    __slots__ = ("shape", "dtype", "ndim")

    def __init__(self, t):
        self.shape = tuple(t.shape)
        self.dtype = str(t.dtype).replace("torch.", "")
        self.ndim = len(self.shape)


def meta(a):
    """``a`` as a validator takes it: tensors as :class:`Meta`, lists and
    tuples element by element, anything else as it is."""
    if isinstance(a, torch.Tensor):
        return Meta(a)
    if type(a) in (list, tuple):
        return type(a)(meta(x) for x in a)
    return a


_VALIDATORS: dict = {}


def register_validator(name):
    def deco(fn):
        _VALIDATORS[name] = fn
        return fn

    return deco


def validate(op_name, datas, attrs):
    """Run ``op_name``'s validator, if it has one, on ``datas`` (the op's
    positional operands, tensors read as :func:`meta`) and ``attrs``."""
    fn = _VALIDATORS.get(op_name)
    if fn is not None:
        fn(tuple(meta(d) for d in datas),
           {k: meta(v) for k, v in attrs.items()})


def _shape(x):
    return tuple(getattr(x, "shape", ()))


def _ndim(x):
    return len(_shape(x))


def _fail(op, msg):
    raise InvalidArgumentError(
        f"(InvalidArgument) {msg} [operator < {op} > error]")


@register_validator("matmul")
def _matmul(datas, attrs):
    x, y = datas[0], datas[1]
    xs, ys = _shape(x), _shape(y)
    if not xs or not ys:
        _fail("matmul", f"matmul inputs must have rank >= 1, got "
                        f"x{list(xs)} @ y{list(ys)}")
    tx = bool(attrs.get("transpose_x", False))
    ty = bool(attrs.get("transpose_y", False))
    kx = xs[-2] if (tx and len(xs) > 1) else xs[-1]
    ky = (ys[-1] if ty else ys[-2]) if len(ys) > 1 else ys[0]
    if kx != ky:
        _fail("matmul",
              f"Input X's width should be equal to Y's height, but "
              f"received X'shape: {list(xs)}, Y'shape: {list(ys)} "
              f"(contracted dims {kx} vs {ky}, transpose_x={tx}, "
              f"transpose_y={ty})")
    # batch 13: MatmulInferMeta also broadcasts the batch dims (every
    # dim left of the matrix dims) — a mismatch otherwise surfaces as
    # a jnp dot_general error deep inside dispatch
    try:
        np.broadcast_shapes(xs[:-2], ys[:-2])
    except ValueError:
        _fail("matmul",
              f"The batch dimensions of Input(X) {list(xs)} and "
              f"Input(Y) {list(ys)} are not broadcast-compatible")


@register_validator("concat")
def _concat(datas, attrs):
    axis = int(attrs.get("axis", 0))
    shapes = [_shape(d) for d in datas]
    if not shapes:
        _fail("concat", "concat expects at least one input")
    base = shapes[0]
    nd = len(base)
    ax = axis + nd if axis < 0 else axis
    if not 0 <= ax < nd:
        _fail("concat", f"axis {axis} out of range for rank {nd}")
    for i, s in enumerate(shapes[1:], 1):
        if len(s) != nd:
            _fail("concat",
                  f"all inputs must share rank; input 0 has rank {nd}, "
                  f"input {i} has rank {len(s)}")
        for d in range(nd):
            if d != ax and s[d] != base[d]:
                _fail("concat",
                      f"The shape of input[0] and input[{i}] is "
                      f"expected to be equal except on axis {ax}, but "
                      f"received input[0]: {list(base)} vs input[{i}]: "
                      f"{list(s)}")


@register_validator("reshape")
def _reshape(datas, attrs):
    x = datas[0]
    shape = attrs.get("shape")
    if shape is None:
        return
    n = int(np.prod(_shape(x))) if _shape(x) else 1
    known = 1
    minus1 = 0
    for s in shape:
        if s == -1:
            minus1 += 1
        elif s == 0:
            continue  # reference: 0 copies the input dim
        else:
            known *= int(s)
    if minus1 > 1:
        _fail("reshape", f"only one dim may be -1, got shape {shape}")
    if minus1 == 0 and known != n and 0 not in shape:
        _fail("reshape",
              f"the number of elements ({n}) is not equal to the "
              f"target shape {list(shape)} ({known} elements)")
    if minus1 == 1 and known and n % known != 0:
        _fail("reshape",
              f"cannot infer -1: {n} elements not divisible by "
              f"{known} (target shape {list(shape)})")


@register_validator("conv2d")
def _conv2d(datas, attrs):
    x, w = datas[0], datas[1]
    xs, ws = _shape(x), _shape(w)
    if len(xs) != 4 or len(ws) != 4:
        _fail("conv2d",
              f"conv2d expects 4-D input and filter, got input "
              f"{list(xs)}, filter {list(ws)}")
    groups = int(attrs.get("groups", 1))
    fmt = attrs.get("data_format", "NCHW")
    in_ch = xs[1] if fmt == "NCHW" else xs[-1]
    if in_ch != ws[1] * groups:
        _fail("conv2d",
              f"The number of input's channels should be equal to "
              f"filter's channels * groups, but received input "
              f"channels {in_ch}, filter shape {list(ws)}, groups "
              f"{groups}")
    if ws[0] % groups != 0:
        _fail("conv2d",
              f"output channels {ws[0]} must be divisible by groups "
              f"{groups}")


@register_validator("embedding")
def _embedding(datas, attrs):
    # arg order matches the embedding op's signature — the call site
    # (nn/functional/__init__.py embedding) passes (weight, ids)
    table, ids = datas[0], datas[1]
    if _ndim(table) != 2:
        _fail("embedding",
              f"the weight must be 2-D [vocab, dim], got "
              f"{list(_shape(table))}")
    dt = getattr(ids, "dtype", None)
    if dt is not None and not np.issubdtype(np.dtype(str(dt)),
                                            np.integer):
        _fail("embedding",
              f"the input ids must be an integer dtype, got {dt}")


def _linear(datas, attrs):  # F.linear rides matmul; kept for custom use
    x, w = datas[0], datas[1]
    xs, ws = _shape(x), _shape(w)
    if len(ws) != 2:
        _fail("linear", f"weight must be 2-D [in, out], got {list(ws)}")
    if xs and xs[-1] != ws[0]:
        _fail("linear",
              f"Input's last dim ({xs[-1]}) should equal weight's "
              f"first dim ({ws[0]}); input {list(xs)}, weight "
              f"{list(ws)}")


@register_validator("where")
def _where(datas, attrs):
    if len(datas) < 3:
        return
    c, x, y = datas[0], datas[1], datas[2]
    try:
        np.broadcast_shapes(_shape(c), _shape(x), _shape(y))
    except ValueError:
        _fail("where",
              f"condition/x/y are not broadcast-compatible: "
              f"{list(_shape(c))}, {list(_shape(x))}, "
              f"{list(_shape(y))}")


@register_validator("softmax_with_cross_entropy")
def _cross_entropy(datas, attrs):
    logits, label = datas[0], datas[1]
    ls, ys = _shape(logits), _shape(label)
    if not ls:
        _fail("softmax_with_cross_entropy",
              "logits must be at least 1-D")
    if attrs.get("soft_label"):
        if ls != ys:
            _fail("cross_entropy",
                  f"soft labels must match logits shape {list(ls)}, "
                  f"got {list(ys)}")
        return
    if len(ys) == len(ls) and ys[-1] not in (1, ls[-1]):
        _fail("cross_entropy",
              f"hard label's last dim must be 1, got label "
              f"{list(ys)} for logits {list(ls)}")


def _int_dtype(x):
    dt = getattr(x, "dtype", None)
    return dt is None or np.issubdtype(np.dtype(str(dt)), np.integer)


def _axis_in(op, axis, nd, extra=0):
    """Normalize ``axis`` against rank ``nd`` (+``extra`` for ops that
    insert dims); fail with the reference-style message if out of range."""
    lo, hi = -(nd + extra), nd + extra
    if not lo <= axis < hi:
        _fail(op,
              f"The axis is expected to be in range of [{lo}, {hi}), "
              f"but got {axis}")
    return axis % hi if axis < 0 else axis


@register_validator("stack")
def _stack(datas, attrs):
    shapes = [_shape(d) for d in datas]
    if not shapes:
        _fail("stack", "stack expects at least one input")
    base = shapes[0]
    for i, s in enumerate(shapes[1:], 1):
        if s != base:
            _fail("stack",
                  f"inputs to stack must all have the same shape; "
                  f"input[0]: {list(base)} vs input[{i}]: {list(s)}")
    _axis_in("stack", int(attrs.get("axis", 0)), len(base), extra=1)


@register_validator("gather")
def _gather(datas, attrs):
    x, index = datas[0], datas[1]
    if not _int_dtype(index):
        _fail("gather",
              f"the index must be an integer dtype, got "
              f"{getattr(index, 'dtype', None)}")
    if _ndim(index) > 1:
        _fail("gather",
              f"the index should be a 0-D or 1-D tensor, got rank "
              f"{_ndim(index)}")
    _axis_in("gather", int(attrs.get("axis", 0)), max(_ndim(x), 1))


@register_validator("scatter")
def _scatter(datas, attrs):
    x, index, updates = datas[0], datas[1], datas[2]
    if not _int_dtype(index):
        _fail("scatter",
              f"the index must be an integer dtype, got "
              f"{getattr(index, 'dtype', None)}")
    xs, us = _shape(x), _shape(updates)
    if _ndim(index) == 1 and len(us) == len(xs) and len(xs) >= 1:
        if us[0] != _shape(index)[0]:
            _fail("scatter",
                  f"updates' first dim should equal index length "
                  f"({_shape(index)[0]}), but received updates "
                  f"{list(us)}")
        if us[1:] != xs[1:]:
            _fail("scatter",
                  f"updates' trailing dims should match input's "
                  f"({list(xs[1:])}), but received updates {list(us)}")


@register_validator("take_along_axis")
def _take_along_axis(datas, attrs):
    x, index = datas[0], datas[1]
    if not _int_dtype(index):
        _fail("take_along_axis",
              f"the indices must be an integer dtype, got "
              f"{getattr(index, 'dtype', None)}")
    if _ndim(index) != _ndim(x):
        _fail("take_along_axis",
              f"indices rank ({_ndim(index)}) must equal input rank "
              f"({_ndim(x)}); input {list(_shape(x))}, indices "
              f"{list(_shape(index))}")
    _axis_in("take_along_axis", int(attrs.get("axis", 0)),
             max(_ndim(x), 1))


@register_validator("squeeze")
def _squeeze(datas, attrs):
    x = datas[0]
    axis = attrs.get("axis")
    if axis is None:
        return
    nd = _ndim(x)
    for a in (axis if isinstance(axis, (list, tuple)) else (axis,)):
        _axis_in("squeeze", int(a), nd)


@register_validator("unsqueeze")
def _unsqueeze(datas, attrs):
    x = datas[0]
    axis = attrs.get("axis")
    axes = axis if isinstance(axis, (list, tuple)) else (axis,)
    # rank grows by one per inserted dim; each axis addresses the
    # already-expanded rank (jnp.expand_dims semantics).
    nd = _ndim(x) + len(axes) - 1
    for a in axes:
        _axis_in("unsqueeze", int(a), nd, extra=1)


@register_validator("tile")
def _tile(datas, attrs):
    rt = attrs.get("repeat_times", ())
    for r in rt:
        if int(r) <= 0:
            _fail("tile",
                  f"every element of repeat_times must be a positive "
                  f"integer, got {list(rt)}")


@register_validator("pad")
def _pad(datas, attrs):
    pw = attrs.get("pad_width", ())
    for pair in pw:
        lo, hi = pair
        if int(lo) < 0 or int(hi) < 0:
            _fail("pad",
                  f"paddings must be non-negative, got "
                  f"{[list(p) for p in pw]}")


@register_validator("expand")
def _expand(datas, attrs):
    x = datas[0]
    shape = attrs.get("shape", ())
    xs = _shape(x)
    if len(shape) < len(xs):
        _fail("expand",
              f"the target shape's rank ({len(shape)}) must be >= the "
              f"input's rank ({len(xs)}); input {list(xs)}, target "
              f"{list(shape)}")
    for xd, td in zip(xs[::-1], tuple(shape)[::-1]):
        if xd != 1 and xd != td:
            _fail("expand",
                  f"input shape {list(xs)} cannot expand to "
                  f"{list(shape)}: dim {xd} is neither 1 nor {td}")


@register_validator("transpose")
def _transpose(datas, attrs):
    x = datas[0]
    perm = attrs.get("perm", ())
    nd = _ndim(x)
    if len(perm) != nd:
        _fail("transpose",
              f"perm's length ({len(perm)}) must equal input rank "
              f"({nd}); perm {list(perm)}")
    norm = [int(p) + nd if int(p) < 0 else int(p) for p in perm]
    if sorted(norm) != list(range(nd)):
        _fail("transpose",
              f"perm {list(perm)} is not a permutation of "
              f"[0, {nd})")


@register_validator("split")
def _split(datas, attrs):
    x = datas[0]
    num = attrs.get("num_or_sections")
    axis = int(attrs.get("axis", 0))
    xs = _shape(x)
    ax = axis + len(xs) if axis < 0 else axis
    if not 0 <= ax < len(xs):
        _fail("split", f"axis {axis} out of range for rank {len(xs)}")
    if isinstance(num, int):
        if num <= 0 or xs[ax] % num != 0:
            _fail("split",
                  f"The input's size along the split dimension must be "
                  f"evenly divisible by num ({num}), but received "
                  f"dim {ax} = {xs[ax]}")
    elif isinstance(num, (list, tuple)):
        fixed = sum(s for s in num if s != -1)
        n_infer = sum(1 for s in num if s == -1)
        if n_infer > 1:
            _fail("split", f"only one section may be -1, got {num}")
        if n_infer == 0 and fixed != xs[ax]:
            _fail("split",
                  f"sections {list(num)} must sum to dim {ax} = "
                  f"{xs[ax]}")
        if n_infer == 1 and fixed > xs[ax]:
            _fail("split",
                  f"sections {list(num)} exceed dim {ax} = {xs[ax]}")


@register_validator("cumsum")
def _cumsum(datas, attrs):
    x = datas[0]
    axis = attrs.get("axis")
    if axis is None:
        return  # reference: None flattens first
    _axis_in("cumsum", int(axis), max(_ndim(x), 1))


@register_validator("argsort")
def _argsort(datas, attrs):
    x = datas[0]
    _axis_in("argsort", int(attrs.get("axis", -1)), max(_ndim(x), 1))


@register_validator("topk")
def _topk(datas, attrs):
    x = datas[0]
    k = int(attrs.get("k", 1))
    xs = _shape(x)
    nd = max(len(xs), 1)
    ax = _axis_in("topk", int(attrs.get("axis", -1)), nd)
    if k < 1:
        _fail("topk",
              f"the attribute of k in the topk must be >= 1, but "
              f"received {k}")
    if xs and k > xs[ax]:
        _fail("topk",
              f"k ({k}) must be <= the input's size along axis {ax} "
              f"({xs[ax]}); input shape {list(xs)}")


@register_validator("clip")
def _clip(datas, attrs):
    lo, hi = attrs.get("min"), attrs.get("max")
    if lo is not None and hi is not None \
            and not hasattr(lo, "ndim") and not hasattr(hi, "ndim") \
            and float(lo) > float(hi):
        _fail("clip",
              f"max should be greater than or equal to min, but "
              f"received min = {lo}, max = {hi}")


@register_validator("one_hot")
def _one_hot(datas, attrs):
    x = datas[0]
    n = int(attrs.get("num_classes", 0))
    if n < 1:
        _fail("one_hot",
              f"num_classes should be a positive integer, but "
              f"received {n}")
    if not _int_dtype(x):
        _fail("one_hot",
              f"the input must be an integer dtype, got "
              f"{getattr(x, 'dtype', None)}")


@register_validator("flip")
def _flip(datas, attrs):
    x = datas[0]
    axis = attrs.get("axis")
    nd = max(_ndim(x), 1)
    axes = axis if isinstance(axis, (list, tuple)) else (axis,)
    seen = set()
    for a in axes:
        n = _axis_in("flip", int(a), nd)
        if n in seen:
            _fail("flip", f"axis {list(axes)} has duplicate entries")
        seen.add(n)


@register_validator("roll")
def _roll(datas, attrs):
    x = datas[0]
    shifts = attrs.get("shifts")
    axis = attrs.get("axis")
    if axis is None:
        return  # reference: roll on the flattened tensor
    nd = max(_ndim(x), 1)
    axes = axis if isinstance(axis, (list, tuple)) else (axis,)
    for a in axes:
        _axis_in("roll", int(a), nd)
    if isinstance(shifts, (list, tuple)) \
            and len(shifts) != len(tuple(axes)):
        _fail("roll",
              f"shifts ({list(shifts)}) and axis ({list(axes)}) must "
              f"have the same length")


@register_validator("diag")
def _diag(datas, attrs):
    nd = _ndim(datas[0])
    if nd not in (1, 2):
        _fail("diag",
              f"the input must be a 1-D or 2-D tensor, but received "
              f"rank {nd} (shape {list(_shape(datas[0]))})")


@register_validator("diagonal")
def _diagonal(datas, attrs):
    xs = _shape(datas[0])
    nd = len(xs)
    if nd < 2:
        _fail("diagonal",
              f"the input must have rank >= 2, but received rank {nd} "
              f"(shape {list(xs)})")
    a1 = _axis_in("diagonal", int(attrs.get("axis1", 0)), nd)
    a2 = _axis_in("diagonal", int(attrs.get("axis2", 1)), nd)
    if a1 == a2:
        _fail("diagonal",
              f"axis1 and axis2 must refer to different dimensions, "
              f"but both resolve to {a1}")


@register_validator("tril")
def _tril(datas, attrs):
    nd = _ndim(datas[0])
    if nd < 2:
        _fail("tril",
              f"the input must have rank >= 2, but received rank {nd} "
              f"(shape {list(_shape(datas[0]))})")


@register_validator("triu")
def _triu(datas, attrs):
    nd = _ndim(datas[0])
    if nd < 2:
        _fail("triu",
              f"the input must have rank >= 2, but received rank {nd} "
              f"(shape {list(_shape(datas[0]))})")


@register_validator("repeat_interleave")
def _repeat_interleave(datas, attrs):
    xs = _shape(datas[0])
    repeats = attrs.get("repeats")
    axis = attrs.get("axis")
    if axis is not None:
        ax = _axis_in("repeat_interleave", int(axis), max(len(xs), 1))
    if isinstance(repeats, (list, tuple)):
        if any(int(r) < 0 for r in repeats):
            _fail("repeat_interleave",
                  f"repeats must all be non-negative, got "
                  f"{list(repeats)}")
        size = (int(np.prod(xs)) if axis is None
                else (xs[ax] if xs else 1))
        if len(repeats) not in (1, size):
            _fail("repeat_interleave",
                  f"repeats has {len(repeats)} entries but the "
                  f"repeated dimension has size {size}")
    elif repeats is not None and int(repeats) < 0:
        _fail("repeat_interleave",
              f"repeats must be non-negative, got {repeats}")


@register_validator("cross")
def _cross(datas, attrs):
    xs, ys = _shape(datas[0]), _shape(datas[1])
    if xs != ys:
        _fail("cross",
              f"the inputs must have the same shape, but received "
              f"x{list(xs)} vs y{list(ys)}")
    ax = _axis_in("cross", int(attrs.get("axis", 0)), max(len(xs), 1))
    if xs and xs[ax] != 3:
        _fail("cross",
              f"the size along the cross axis must be 3, but "
              f"dimension {ax} of {list(xs)} is {xs[ax]}")


@register_validator("moveaxis")
def _moveaxis(datas, attrs):
    nd = max(_ndim(datas[0]), 1)
    src = attrs.get("source")
    dst = attrs.get("destination")
    srcs = src if isinstance(src, (list, tuple)) else (src,)
    dsts = dst if isinstance(dst, (list, tuple)) else (dst,)
    if len(srcs) != len(dsts):
        _fail("moveaxis",
              f"source ({list(srcs)}) and destination ({list(dsts)}) "
              f"must have the same number of axes")
    for name, axes in (("source", srcs), ("destination", dsts)):
        seen = set()
        for a in axes:
            n = _axis_in("moveaxis", int(a), nd)
            if n in seen:
                _fail("moveaxis",
                      f"{name} axes {list(axes)} have duplicates")
            seen.add(n)


@register_validator("meshgrid")
def _meshgrid(datas, attrs):
    # host-side op: the wrapper calls validate() directly
    if not datas:
        _fail("meshgrid", "meshgrid expects at least one input")
    for i, d in enumerate(datas):
        if _ndim(d) > 1:
            _fail("meshgrid",
                  f"each input must be 0-D or 1-D, but input {i} has "
                  f"shape {list(_shape(d))}")


@register_validator("sort")
def _sort(datas, attrs):
    _axis_in("sort", int(attrs.get("axis", -1)),
             max(_ndim(datas[0]), 1))


@register_validator("masked_fill")
def _masked_fill(datas, attrs):
    x, mask, value = datas[0], datas[1], datas[2]
    dt = getattr(mask, "dtype", None)
    if dt is not None and np.dtype(str(dt)) != np.bool_:
        _fail("masked_fill",
              f"the mask must be a bool tensor, got {dt}")
    try:
        np.broadcast_shapes(_shape(x), _shape(mask), _shape(value))
    except ValueError:
        _fail("masked_fill",
              f"the mask {list(_shape(mask))} / value "
              f"{list(_shape(value))} are not broadcast-compatible "
              f"with the input {list(_shape(x))}")


@register_validator("put_along_axis")
def _put_along_axis(datas, attrs):
    x, indices = datas[0], datas[1]
    if not _int_dtype(indices):
        _fail("put_along_axis",
              f"the indices must be an integer dtype, got "
              f"{getattr(indices, 'dtype', None)}")
    if _ndim(indices) != _ndim(x):
        _fail("put_along_axis",
              f"indices rank ({_ndim(indices)}) must equal input rank "
              f"({_ndim(x)}); input {list(_shape(x))}, indices "
              f"{list(_shape(indices))}")
    _axis_in("put_along_axis", int(attrs.get("axis", 0)),
             max(_ndim(x), 1))
    reduce = attrs.get("reduce", "assign")
    if reduce not in ("assign", "add", "mul", "multiply"):
        _fail("put_along_axis",
              f"the reduce should be one of 'assign', 'add', 'mul' / "
              f"'multiply', but received {reduce!r}")


@register_validator("nonzero")
def _nonzero(datas, attrs):
    # host-side op: the wrapper calls validate() directly
    if _ndim(datas[0]) < 1:
        _fail("nonzero",
              f"the input must have rank >= 1, but received rank "
              f"{_ndim(datas[0])}")


@register_validator("unique")
def _unique(datas, attrs):
    # host-side op: the wrapper calls validate() directly
    axis = attrs.get("axis")
    if axis is not None:
        _axis_in("unique", int(axis), max(_ndim(datas[0]), 1))


@register_validator("flatten")
def _flatten(datas, attrs):
    # host-side op (rides reshape): the wrapper calls validate() first
    nd = max(_ndim(datas[0]), 1)
    start = _axis_in("flatten", int(attrs.get("start_axis", 0)), nd)
    stop = _axis_in("flatten", int(attrs.get("stop_axis", -1)), nd)
    if start > stop:
        _fail("flatten",
              f"the start_axis ({attrs.get('start_axis')}) should be "
              f"no greater than stop_axis ({attrs.get('stop_axis')}) "
              f"for input rank {nd}")


@register_validator("unbind")
def _unbind(datas, attrs):
    # host-side op (split + squeeze): the wrapper calls validate() first
    _axis_in("unbind", int(attrs.get("axis", 0)),
             max(_ndim(datas[0]), 1))


@register_validator("bincount")
def _bincount(datas, attrs):
    # host-side op: the wrapper calls validate() directly
    x = datas[0]
    if _ndim(x) != 1:
        _fail("bincount",
              f"the input must be a 1-D tensor, but received shape "
              f"{list(_shape(x))}")
    if not _int_dtype(x):
        _fail("bincount",
              f"the input must be an integer dtype, got "
              f"{getattr(x, 'dtype', None)}")
    w = datas[1] if len(datas) > 1 else None
    if w is not None and _shape(w) != _shape(x):
        _fail("bincount",
              f"the weights {list(_shape(w))} must have the same shape "
              f"as the input {list(_shape(x))}")
    if int(attrs.get("minlength", 0)) < 0:
        _fail("bincount",
              f"minlength should be non-negative, but received "
              f"{attrs.get('minlength')}")


@register_validator("logsumexp")
def _logsumexp(datas, attrs):
    x = datas[0]
    axis = attrs.get("axis")
    if axis is None:
        return  # reference: None reduces over all dims
    nd = max(_ndim(x), 1)
    axes = axis if isinstance(axis, (list, tuple)) else (axis,)
    seen = set()
    for a in axes:
        n = _axis_in("logsumexp", int(a), nd)
        if n in seen:
            _fail("logsumexp",
                  f"axis {list(axes)} has duplicate entries")
        seen.add(n)


@register_validator("cumprod")
def _cumprod(datas, attrs):
    dim = attrs.get("dim")
    if dim is None:
        return  # reference: None multiplies the flattened tensor
    _axis_in("cumprod", int(dim), max(_ndim(datas[0]), 1))


@register_validator("strided_slice")
def _strided_slice(datas, attrs):
    x = datas[0]
    axes = tuple(attrs.get("axes", ()))
    starts = tuple(attrs.get("starts", ()))
    ends = tuple(attrs.get("ends", ()))
    strides = tuple(attrs.get("strides", ()))
    if not (len(axes) == len(starts) == len(ends) == len(strides)):
        _fail("strided_slice",
              f"the lengths of axes ({len(axes)}), starts "
              f"({len(starts)}), ends ({len(ends)}) and strides "
              f"({len(strides)}) must be equal")
    nd = max(_ndim(x), 1)
    seen = set()
    for a in axes:
        n = _axis_in("strided_slice", int(a), nd)
        if n in seen:
            _fail("strided_slice",
                  f"axes {list(axes)} have duplicate entries")
        seen.add(n)
    for st in strides:
        if int(st) == 0:
            _fail("strided_slice",
                  f"stride must be non-zero, got strides "
                  f"{list(strides)}")


@register_validator("gather_nd")
def _gather_nd(datas, attrs):
    x, index = datas[0], datas[1]
    if not _int_dtype(index):
        _fail("gather_nd",
              f"the index must be an integer dtype, got "
              f"{getattr(index, 'dtype', None)}")
    xs, ixs = _shape(x), _shape(index)
    if not ixs:
        _fail("gather_nd",
              f"the index must have rank >= 1, but received rank 0")
    if ixs[-1] > len(xs):
        _fail("gather_nd",
              f"the last dimension of index ({ixs[-1]}) must be <= "
              f"the input's rank ({len(xs)}); input {list(xs)}, "
              f"index {list(ixs)}")


@register_validator("dot")
def _dot(datas, attrs):
    xs, ys = _shape(datas[0]), _shape(datas[1])
    if len(xs) not in (1, 2) or len(ys) not in (1, 2):
        _fail("dot",
              f"the inputs must be 1-D or 2-D tensors, but received "
              f"x{list(xs)} . y{list(ys)}")
    if xs != ys:
        _fail("dot",
              f"the inputs must have the same shape, but received "
              f"x{list(xs)} vs y{list(ys)}")


@register_validator("addmm")
def _addmm(datas, attrs):
    inp, x, y = datas[0], datas[1], datas[2]
    ins, xs, ys = _shape(inp), _shape(x), _shape(y)
    if len(xs) != 2 or len(ys) != 2:
        _fail("addmm",
              f"the tensors x and y must be 2-D, but received "
              f"x{list(xs)}, y{list(ys)}")
    if xs[1] != ys[0]:
        _fail("addmm",
              f"Input X's width should be equal to Y's height, but "
              f"received X'shape: {list(xs)}, Y'shape: {list(ys)}")
    out = (xs[0], ys[1])
    try:
        ok = np.broadcast_shapes(ins, out) == out
    except ValueError:
        ok = False
    if not ok:
        _fail("addmm",
              f"the input {list(ins)} is not broadcast-compatible "
              f"with the x @ y result shape {list(out)}")


@register_validator("searchsorted")
def _searchsorted(datas, attrs):
    ss = datas[0]
    if _ndim(ss) != 1:
        _fail("searchsorted",
              f"sorted_sequence must be a 1-D tensor here, but "
              f"received shape {list(_shape(ss))}")


@register_validator("index_add")
def _index_add(datas, attrs):
    # positional signature (x, index, axis, value) — ADVICE r3; axis
    # rides in datas unless the caller passed it by keyword.
    x, index = datas[0], datas[1]
    if "axis" in attrs:
        axis = int(attrs["axis"])
        value = datas[2] if len(datas) > 2 else None
    elif len(datas) > 3:
        axis, value = int(datas[2]), datas[3]
    else:
        return
    if not _int_dtype(index):
        _fail("index_add",
              f"the index must be an integer dtype, got "
              f"{getattr(index, 'dtype', None)}")
    if _ndim(index) > 1:
        _fail("index_add",
              f"the index should be a 0-D or 1-D tensor, got rank "
              f"{_ndim(index)}")
    nd = max(_ndim(x), 1)
    ax = _axis_in("index_add", axis, nd)
    xs, vs = _shape(x), _shape(value)
    if value is not None and len(vs) == len(xs) and xs:
        n_idx = _shape(index)[0] if _ndim(index) == 1 else 1
        expect = xs[:ax] + (n_idx,) + xs[ax + 1:]
        if vs != expect:
            _fail("index_add",
                  f"the value's shape {list(vs)} must match the "
                  f"input's except along axis {ax} where it must "
                  f"equal the index length ({n_idx}); expected "
                  f"{list(expect)}")


@register_validator("masked_select")
def _masked_select(datas, attrs):
    # host-side op: the wrapper calls validate() directly (it never
    # goes through registry.apply)
    x, mask = datas[0], datas[1]
    dt = getattr(mask, "dtype", None)
    if dt is not None and np.dtype(str(dt)) != np.bool_:
        _fail("masked_select",
              f"the mask must be a bool tensor, got {dt}")
    try:
        np.broadcast_shapes(_shape(x), _shape(mask))
    except ValueError:
        _fail("masked_select",
              f"the mask {list(_shape(mask))} is not broadcast-"
              f"compatible with the input {list(_shape(x))}")


# -- batch 7 (r14): math/selection tail toward the top-50 -------------------

@register_validator("trace")
def _trace(datas, attrs):
    # unary.cc TraceInferMeta
    x = datas[0]
    nd = _ndim(x)
    if nd < 2:
        _fail("trace",
              f"Input's dim is out of range (expected at least 2, but "
              f"got {nd})")
    a1 = _axis_in("trace", int(attrs.get("axis1", 0)), nd)
    a2 = _axis_in("trace", int(attrs.get("axis2", 1)), nd)
    if a1 == a2:
        _fail("trace",
              f"The dimensions should not be identical "
              f"{attrs.get('axis1', 0)} vs {attrs.get('axis2', 1)}")


@register_validator("kthvalue")
def _kthvalue(datas, attrs):
    # unary.cc KthvalueInferMeta
    x = datas[0]
    nd = max(_ndim(x), 1)
    ax = _axis_in("kthvalue", int(attrs.get("axis", -1)), nd)
    k = int(attrs.get("k", 1))
    if k < 1:
        _fail("kthvalue",
              f"the k in the kthvalue must >= 1, but received {k}")
    xs = _shape(x)
    if xs and k > xs[ax]:
        _fail("kthvalue",
              f"the k in the kthvalue must less equal than the size of "
              f"axis {ax} ({xs[ax]}), but received {k}")


@register_validator("mode")
def _mode(datas, attrs):
    # unary.cc ModeInferMeta
    x = datas[0]
    _axis_in("mode", int(attrs.get("axis", -1)), max(_ndim(x), 1))


@register_validator("index_sample")
def _index_sample(datas, attrs):
    # binary.cc IndexSampleInferMeta
    x, index = datas[0], datas[1]
    if _ndim(x) != 2:
        _fail("index_sample",
              f"Inputs(X) shape of IndexSample op should be 2-D, but "
              f"got X's shape = {list(_shape(x))}")
    if _ndim(index) != 2:
        _fail("index_sample",
              f"Inputs(Index) shape of IndexSample op should be 2-D, "
              f"but got Index's shape = {list(_shape(index))}")
    if not _int_dtype(index):
        _fail("index_sample",
              f"the index must be an integer dtype, got "
              f"{getattr(index, 'dtype', None)}")
    if _shape(x)[0] != _shape(index)[0]:
        _fail("index_sample",
              f"Inputs(X)'s value of dimension 0 must same with "
              f"Inputs(Index), but X's batch is {_shape(x)[0]} and "
              f"Index's batch is {_shape(index)[0]}")


@register_validator("renorm")
def _renorm(datas, attrs):
    # unary.cc RenormInferMeta (+ the p > 0 contract of the p-norm)
    x = datas[0]
    _axis_in("renorm", int(attrs.get("axis", -1)), max(_ndim(x), 1))
    p = float(attrs.get("p", 2.0))
    if p <= 0:
        _fail("renorm",
              f"the p of the renorm p-norm must be positive, but "
              f"received {p}")
    max_norm = float(attrs.get("max_norm", 0.0))
    if max_norm < 0:
        _fail("renorm",
              f"the max_norm must be non-negative, but received "
              f"{max_norm}")


@register_validator("cdist")
def _cdist(datas, attrs):
    # binary.cc CdistInferMeta
    x, y = datas[0], datas[1]
    if _ndim(x) < 2 or _ndim(y) < 2:
        _fail("cdist",
              f"the x and y must have at least 2 dimensions, got "
              f"x{list(_shape(x))} and y{list(_shape(y))}")
    if _shape(x)[-1] != _shape(y)[-1]:
        _fail("cdist",
              f"the x and y should have same value at dim -1, but got "
              f"{_shape(x)[-1]} and {_shape(y)[-1]}")
    p = float(attrs.get("p", 2.0))
    if p < 0:
        _fail("cdist",
              f"the p must be non-negative, but received {p}")


@register_validator("multinomial")
def _multinomial(datas, attrs):
    # unary.cc MultinomialInferMeta — host-side op: the wrapper calls
    # validate() directly (sampling never goes through registry.apply)
    x = datas[0]
    nd = _ndim(x)
    if nd < 1 or nd > 2:
        _fail("multinomial",
              f"The number of dimensions of the input probability "
              f"distribution should be > 0 and <= 2, but got {nd}")
    n = int(attrs.get("num_samples", 1))
    if n < 1:
        _fail("multinomial",
              f"The number of samples should be > 0, but got {n}")
    if not attrs.get("replacement", False):
        cats = _shape(x)[-1]
        if n > cats:
            _fail("multinomial",
                  f"When replacement is False, number of samples "
                  f"should be less than or equal to the number of "
                  f"categories ({cats}), but got {n}")


@register_validator("histogram")
def _histogram(datas, attrs):
    # unary.cc HistogramInferMeta — host-side op, wrapper-invoked
    bins = int(attrs.get("bins", 100))
    if bins < 1:
        _fail("histogram",
              f"the bins should be >= 1, but received {bins}")
    lo, hi = attrs.get("min", 0), attrs.get("max", 0)
    if float(hi) < float(lo):
        _fail("histogram",
              f"max must be larger or equal to min, but received "
              f"min {lo} and max {hi}")


def _reduce_axes(op, datas, attrs):
    """Shared unary-reduction check (unary.cc ReduceInferMetaBase):
    ``axis`` None / int / tuple, every entry in range, no duplicates."""
    axis = attrs.get("axis")
    if axis is None:
        return
    nd = max(_ndim(datas[0]), 1)
    axes = axis if isinstance(axis, (list, tuple)) else (axis,)
    seen = set()
    for a in axes:
        n = _axis_in(op, int(a), nd)
        if n in seen:
            _fail(op, f"axis {list(axes)} has duplicate entries")
        seen.add(n)


@register_validator("reduce_prod")
def _reduce_prod(datas, attrs):
    _reduce_axes("reduce_prod", datas, attrs)


@register_validator("amax")
def _amax(datas, attrs):
    _reduce_axes("amax", datas, attrs)


@register_validator("amin")
def _amin(datas, attrs):
    _reduce_axes("amin", datas, attrs)


@register_validator("median")
def _median(datas, attrs):
    _reduce_axes("median", datas, attrs)


@register_validator("nanmedian")
def _nanmedian(datas, attrs):
    _reduce_axes("nanmedian", datas, attrs)


@register_validator("logcumsumexp")
def _logcumsumexp(datas, attrs):
    # unary.cc CumInferMeta; without this check the kernel's ``axis %
    # ndim`` silently WRAPS an out-of-range axis instead of failing.
    axis = attrs.get("axis")
    if axis is None:
        return
    _axis_in("logcumsumexp", int(axis), max(_ndim(datas[0]), 1))


# -- batch 9: lerp / dist / allclose / isclose / frexp / copysign ------------

def _is_float_dtype(dt):
    if dt is None:
        return True
    s = str(dt)
    if "float" in s:  # covers float16/32/64 AND bfloat16 (which numpy's
        return True   # issubdtype does not place under np.floating)
    try:
        return np.issubdtype(np.dtype(s), np.floating)
    except TypeError:
        return False


def _broadcast_pair(op, x, y, xname="X", yname="Y"):
    xs, ys = _shape(x), _shape(y)
    try:
        return np.broadcast_shapes(xs, ys)
    except ValueError:
        _fail(op,
              f"The shape of {xname} {list(xs)} and the shape of "
              f"{yname} {list(ys)} are not broadcast-compatible")


@register_validator("lerp")
def _lerp(datas, attrs):
    # binary.cc LerpInferMeta: x/y broadcast first, then the weight
    # against the pair (weight may be a python float — shape ())
    xy = _broadcast_pair("lerp", datas[0], datas[1])
    ws = _shape(datas[2])
    try:
        np.broadcast_shapes(xy, ws)
    except ValueError:
        _fail("lerp",
              f"The shape of Weight {list(ws)} is not broadcast-"
              f"compatible with the X/Y result shape {list(xy)}")


@register_validator("copysign")
def _copysign(datas, attrs):
    _broadcast_pair("copysign", datas[0], datas[1])


@register_validator("frexp")
def _frexp(datas, attrs):
    # unary.cc FrexpInferMeta: decomposition is only defined for
    # floating inputs
    dt = getattr(datas[0], "dtype", None)
    if not _is_float_dtype(dt):
        _fail("frexp",
              f"The input's data type must be floating point, but "
              f"received {dt}")


@register_validator("dist")
def _dist(datas, attrs):
    # binary.cc DistInferMeta — composite wrapper, validated manually
    # in linalg.dist (never passes registry.apply)
    _broadcast_pair("dist", datas[0], datas[1])


def _close_check(op, datas, attrs):
    # binary.cc ValueCompareInferMeta + the rtol/atol contract; host
    # path, wrapper-invoked
    _broadcast_pair(op, datas[0], datas[1],
                    xname="input X", yname="input Y")
    for key in ("rtol", "atol"):
        v = attrs.get(key)
        if v is not None and float(v) < 0:
            _fail(op, f"{key} must be non-negative, but received {v}")


@register_validator("allclose")
def _allclose(datas, attrs):
    _close_check("allclose", datas, attrs)


@register_validator("isclose")
def _isclose(datas, attrs):
    _close_check("isclose", datas, attrs)


# -- batch 10: linalg tail (kron / outer / householder_product / --------------
# -- matrix_power / slogdet / pinv) -------------------------------------------

def _square_matrix(op, x, name="X"):
    xs = _shape(x)
    if len(xs) < 2:
        _fail(op,
              f"The Input({name}) should have at least 2 dimensions, "
              f"but received a tensor of shape {list(xs)}")
    if xs[-1] != xs[-2]:
        _fail(op,
              f"The inner-most 2 dimensions of Input({name}) should "
              f"be equal (a square matrix or batches of square "
              f"matrices), but received shape {list(xs)}")
    return xs


@register_validator("kron")
def _kron(datas, attrs):
    # binary.cc KronInferMeta: both operands need rank >= 1 (the
    # output dim is the elementwise product of the right-aligned dims)
    for name, d in (("X", datas[0]), ("Y", datas[1])):
        if _ndim(d) < 1:
            _fail("kron",
                  f"the rank of Input({name}) should be no less than "
                  f"1, but received a 0-D tensor")


@register_validator("outer")
def _outer(datas, attrs):
    # linalg outer flattens both sides; only 0-D operands are rejected
    for name, d in (("X", datas[0]), ("Y", datas[1])):
        if _ndim(d) < 1:
            _fail("outer",
                  f"Input({name}) of outer should be a tensor with "
                  f"rank >= 1, but received a 0-D tensor")


@register_validator("householder_product")
def _householder_product(datas, attrs):
    # unary.cc HouseholderProductInferMeta: x is [*, m, n] reflectors,
    # tau is [*, k] with k <= n <= m and matching batch dims
    x, tau = datas[0], datas[1]
    xs, ts = _shape(x), _shape(tau)
    if len(xs) < 2:
        _fail("householder_product",
              f"The input matrix x must be at least 2-D, but received "
              f"shape {list(xs)}")
    if len(ts) != len(xs) - 1:
        _fail("householder_product",
              f"The input vector tau should have one dimension less "
              f"than x, but received x {list(xs)} and tau {list(ts)}")
    m, n = xs[-2], xs[-1]
    if m < n:
        _fail("householder_product",
              f"The rows of input matrix x must be greater than or "
              f"equal to its columns, but received shape {list(xs)}")
    if ts[-1] > n:
        _fail("householder_product",
              f"The last dim of tau ({ts[-1]}) must not exceed the "
              f"columns of x ({n}), received x {list(xs)} and tau "
              f"{list(ts)}")
    if xs[:-2] != ts[:-1]:
        _fail("householder_product",
              f"The batch dimensions of x and tau should match, but "
              f"received x {list(xs)} and tau {list(ts)}")


@register_validator("matrix_power")
def _matrix_power(datas, attrs):
    # unary.cc MatrixPowerInferMeta: square matrices only (a negative
    # exponent inverts, so squareness is the whole contract)
    _square_matrix("matrix_power", datas[0])


@register_validator("slogdet")
def _slogdet(datas, attrs):
    # unary.cc SlogDeterminantInferMeta
    _square_matrix("slogdet", datas[0], name="Input")


@register_validator("pinv")
def _pinv(datas, attrs):
    # unary.cc PInverseInferMeta — host-path wrapper, validated
    # manually in linalg.pinv (never passes registry.apply).  The
    # hermitian fast path additionally requires squareness.
    x = datas[0]
    xs = _shape(x)
    if len(xs) < 2:
        _fail("pinv",
              f"The input tensor x's dimension of PinvOp should be "
              f"no less than 2, but received shape {list(xs)}")
    if attrs.get("hermitian") and xs[-1] != xs[-2]:
        _fail("pinv",
              f"hermitian=True requires square matrices, but "
              f"received shape {list(xs)}")


# -- batch 11: linalg solves + factorizations (lu / lu_unpack / ---------------
# -- cholesky_solve / triangular_solve / matrix_rank / eigvalsh) --------------

def _batch_broadcast(op, xs, ys, xname="X", yname="Y"):
    """Batch dims (everything left of the matrix dims) must broadcast."""
    try:
        np.broadcast_shapes(xs[:-2], ys[:-2])
    except ValueError:
        _fail(op,
              f"The batch dimensions of Input({xname}) {list(xs)} and "
              f"Input({yname}) {list(ys)} are not broadcast-compatible")


@register_validator("lu")
def _lu(datas, attrs):
    # unary.cc LUInferMeta — host-path wrapper, validated manually in
    # linalg.lu (never passes registry.apply)
    xs = _shape(datas[0])
    if len(xs) < 2:
        _fail("lu",
              f"The rank of input must greater than 2, but received "
              f"input shape {list(xs)}")


@register_validator("lu_unpack")
def _lu_unpack(datas, attrs):
    # unary.cc LUUnpackInferMeta — host-path wrapper, validated
    # manually in linalg.lu_unpack.  Pivots carry one fewer dim than
    # the packed factor and their last dim is min(m, n).
    x, piv = datas[0], datas[1]
    xs, ps = _shape(x), _shape(piv)
    if len(xs) < 2:
        _fail("lu_unpack",
              f"The rank of input must greater than 2, but received "
              f"input shape {list(xs)}")
    if len(ps) != len(xs) - 1:
        _fail("lu_unpack",
              f"The rank of Pivots should be one less than the rank "
              f"of X, but received X {list(xs)} and Pivots {list(ps)}")
    k = min(xs[-2], xs[-1])
    if ps[-1] != k:
        _fail("lu_unpack",
              f"The last dim of Pivots should be min(rows, cols) = "
              f"{k} of X {list(xs)}, but received Pivots {list(ps)}")
    if xs[:-2] != ps[:-1]:
        _fail("lu_unpack",
              f"The batch dimensions of X and Pivots should match, "
              f"but received X {list(xs)} and Pivots {list(ps)}")


@register_validator("cholesky_solve")
def _cholesky_solve(datas, attrs):
    # binary.cc CholeskySolveInferMeta — host-path wrapper, validated
    # manually in linalg.cholesky_solve.  x is the RHS [*, M, K], y
    # the square Cholesky factor [*, M, M].
    x, y = datas[0], datas[1]
    xs = _shape(x)
    if len(xs) < 2:
        _fail("cholesky_solve",
              f"The rank of Input(X) should be no less than 2, but "
              f"received shape {list(xs)}")
    ys = _square_matrix("cholesky_solve", y, name="Y")
    if ys[-1] != xs[-2]:
        _fail("cholesky_solve",
              f"The rows of RHS X should match the order of the "
              f"factor Y, but received X {list(xs)} and Y {list(ys)}")
    _batch_broadcast("cholesky_solve", xs, ys)


@register_validator("triangular_solve")
def _triangular_solve(datas, attrs):
    # binary.cc TriangularSolveInferMeta: x is the square triangular
    # coefficient [*, M, M], y the RHS [*, M, K]
    x, y = datas[0], datas[1]
    xs = _square_matrix("triangular_solve", x)
    ys = _shape(y)
    if len(ys) < 2:
        _fail("triangular_solve",
              f"The rank of Input(Y) should be no less than 2, but "
              f"received shape {list(ys)}")
    if xs[-1] != ys[-2]:
        _fail("triangular_solve",
              f"The last dimension of X should be equal to the "
              f"second-to-last dimension of Y, but received X "
              f"{list(xs)} and Y {list(ys)}")
    _batch_broadcast("triangular_solve", xs, ys)


@register_validator("matrix_rank")
def _matrix_rank(datas, attrs):
    # unary.cc MatrixRankInferMeta — host-path wrapper, validated
    # manually in linalg.matrix_rank.  The hermitian fast path (eigh
    # under the hood) additionally requires squareness.
    xs = _shape(datas[0])
    if len(xs) < 2:
        _fail("matrix_rank",
              f"The dims of input must be greater than 2, but "
              f"received shape {list(xs)}")
    if attrs.get("hermitian") and xs[-1] != xs[-2]:
        _fail("matrix_rank",
              f"if hermitian == true, matrix should be n*n, but "
              f"received shape {list(xs)}")


@register_validator("eigvalsh")
def _eigvalsh(datas, attrs):
    # unary.cc EigvalshInferMeta — host-path wrapper, validated
    # manually in linalg.eigvalsh
    _square_matrix("eigvalsh", datas[0], name="Input")
    uplo = attrs.get("UPLO", "L")
    if uplo not in ("L", "U"):
        _fail("eigvalsh",
              f"UPLO must be 'L' or 'U', but received {uplo!r}")


@register_validator("cholesky")
def _cholesky(datas, attrs):
    # unary.cc CholeskyInferMeta — auto-wired through registry.apply
    _square_matrix("cholesky", datas[0], name="Input")


@register_validator("svd")
def _svd(datas, attrs):
    # unary.cc SvdInferMeta — host-path wrapper, validated manually in
    # linalg.svd
    xs = _shape(datas[0])
    if len(xs) < 2:
        _fail("svd",
              f"The rank of Input(X) should be greater equal than 2, "
              f"but received shape {list(xs)}")


@register_validator("qr")
def _qr(datas, attrs):
    # unary.cc QrInferMeta: rank >= 2 plus the mode grammar ('reduced'
    # and 'complete' return (Q, R); paddle's 'r' keeps R only)
    xs = _shape(datas[0])
    if len(xs) < 2:
        _fail("qr",
              f"The rank of Input(X) should be greater or equal to 2, "
              f"but received shape {list(xs)}")
    mode = attrs.get("mode", "reduced")
    if mode not in ("reduced", "complete", "r"):
        _fail("qr",
              f"QR received unrecognized mode {mode!r}; expected one "
              f"of 'reduced', 'complete', 'r'")


@register_validator("eig")
def _eig(datas, attrs):
    # unary.cc EigInferMeta — the general eigendecomposition needs a
    # square (batch of) matrix
    _square_matrix("eig", datas[0], name="Input")


@register_validator("eigh")
def _eigh(datas, attrs):
    # unary.cc EighInferMeta — square plus the UPLO grammar, the same
    # contract as eigvalsh
    _square_matrix("eigh", datas[0], name="Input")
    uplo = attrs.get("UPLO", "L")
    if uplo not in ("L", "U"):
        _fail("eigh",
              f"UPLO must be 'L' or 'U', but received {uplo!r}")


@register_validator("cond")
def _cond(datas, attrs):
    # unary.cc CondInferMeta: rank >= 2 always; the singular-value
    # norms (p None/2/-2) accept rectangles, every other order inverts
    # the matrix and needs squareness
    xs = _shape(datas[0])
    if len(xs) < 2:
        _fail("cond",
              f"The input of condition number must be a matrix or "
              f"batches of matrices, but received shape {list(xs)}")
    p = attrs.get("p")
    if p not in (None, 1, -1, 2, -2, float("inf"), float("-inf"),
                 "fro", "nuc"):
        _fail("cond",
              f"The p of condition number must be one of None, 1, "
              f"-1, 2, -2, inf, -inf, 'fro', 'nuc', but received "
              f"{p!r}")
    if p not in (None, 2, -2) and xs[-1] != xs[-2]:
        _fail("cond",
              f"The input matrix must be square when p is {p!r}, but "
              f"received shape {list(xs)}")


# -- batch 13: linalg systems + products (solve / lstsq / tensordot / ---------
# -- multi_dot) + matmul batch broadcasting (extends _matmul above) -----------

@register_validator("solve")
def _solve(datas, attrs):
    # binary.cc SolveInferMeta — auto-wired through registry.apply: x
    # is the square coefficient [*, M, M], y the RHS ([*, M, K] or an
    # [M] vector), batch dims broadcast
    x, y = datas[0], datas[1]
    xs = _square_matrix("solve", x)
    ys = _shape(y)
    if not ys:
        _fail("solve",
              f"The rank of Input(Y) should be no less than 1, but "
              f"received a 0-D tensor")
    rows = ys[-2] if len(ys) >= 2 else ys[0]
    if rows != xs[-1]:
        _fail("solve",
              f"The rows of the RHS Y should match the order of the "
              f"coefficient matrix X, but received X {list(xs)} and "
              f"Y {list(ys)}")
    if len(ys) >= 2:
        _batch_broadcast("solve", xs, ys)


@register_validator("lstsq")
def _lstsq(datas, attrs):
    # binary.cc LstsqInferMeta — host-path wrapper, validated manually
    # in linalg.lstsq: x [*, M, N] and y [*, M, K] share their rows
    # and batch dims; the driver grammar is the reference's
    x, y = datas[0], datas[1]
    xs, ys = _shape(x), _shape(y)
    for name, s in (("X", xs), ("Y", ys)):
        if len(s) < 2:
            _fail("lstsq",
                  f"The rank of Input({name}) should be no less than "
                  f"2, but received shape {list(s)}")
    if xs[-2] != ys[-2]:
        _fail("lstsq",
              f"The rows (second-to-last dimension) of X and Y should "
              f"be equal, but received X {list(xs)} and Y {list(ys)}")
    _batch_broadcast("lstsq", xs, ys)
    driver = attrs.get("driver")
    if driver not in (None, "gels", "gelsy", "gelsd", "gelss"):
        _fail("lstsq",
              f"The driver should be one of None, 'gels', 'gelsy', "
              f"'gelsd', 'gelss', but received {driver!r}")


@register_validator("tensordot")
def _tensordot(datas, attrs):
    # tensordot (math.py TensordotInferMeta shape grammar) — auto-wired
    # through registry.apply after the wrapper normalizes axes to an
    # int or a hashable pair
    x, y = datas[0], datas[1]
    xs, ys = _shape(x), _shape(y)
    axes = attrs.get("axes", 2)
    if isinstance(axes, int):
        if axes < 0:
            _fail("tensordot",
                  f"The number of contracted axes must be "
                  f"non-negative, but received {axes}")
        if axes > min(len(xs), len(ys)):
            _fail("tensordot",
                  f"The number of contracted axes ({axes}) must not "
                  f"exceed the rank of either operand, but received "
                  f"x {list(xs)} and y {list(ys)}")
        if axes and xs[len(xs) - axes:] != ys[:axes]:
            _fail("tensordot",
                  f"The contracted dimensions should be equal: the "
                  f"last {axes} dims of x {list(xs)} vs the first "
                  f"{axes} dims of y {list(ys)}")
        return
    if not (isinstance(axes, tuple) and len(axes) == 2):
        return  # unrecognized spelling: jnp's own checks apply
    ax, ay = axes
    ax = (ax,) if isinstance(ax, int) else tuple(ax)
    ay = (ay,) if isinstance(ay, int) else tuple(ay)
    if len(ax) != len(ay):
        _fail("tensordot",
              f"The axes lists for x and y should have the same "
              f"length, but received {list(ax)} and {list(ay)}")
    for a, b in zip(ax, ay):
        if not -len(xs) <= a < len(xs):
            _fail("tensordot",
                  f"The axis {a} is out of range for x of rank "
                  f"{len(xs)}")
        if not -len(ys) <= b < len(ys):
            _fail("tensordot",
                  f"The axis {b} is out of range for y of rank "
                  f"{len(ys)}")
        if xs[a] != ys[b]:
            _fail("tensordot",
                  f"The contracted dimensions should be equal, but "
                  f"x axis {a} has size {xs[a]} and y axis {b} has "
                  f"size {ys[b]}")


@register_validator("multi_dot")
def _multi_dot(datas, attrs):
    # multiary.cc MultiDotInferMeta — host-path wrapper, validated
    # manually in linalg.multi_dot: >= 2 operands, the ends may be
    # vectors, every middle operand must be a matrix, and the chain's
    # adjacent inner dimensions must agree
    shapes = [_shape(d) for d in datas]
    if len(shapes) < 2:
        _fail("multi_dot",
              f"The number of input tensors should be no less than 2, "
              f"but received {len(shapes)}")
    for name, s in (("first", shapes[0]), ("last", shapes[-1])):
        if len(s) not in (1, 2):
            _fail("multi_dot",
                  f"The {name} input tensor can be 1-D or 2-D, but "
                  f"received shape {list(s)}")
    for i, s in enumerate(shapes[1:-1], 1):
        if len(s) != 2:
            _fail("multi_dot",
                  f"The middle input tensors must be 2-D, but "
                  f"input[{i}] has shape {list(s)}")
    k = shapes[0][-1]
    for i, s in enumerate(shapes[1:], 1):
        if s[0] != k:
            _fail("multi_dot",
                  f"The inner dimensions of adjacent operands should "
                  f"be equal, but input[{i - 1}] ends with {k} and "
                  f"input[{i}] {list(s)} starts with {s[0]}")
        k = s[-1]


# -- batch 14: construction + statistics + in-place random fills --------------


def _float_dtype(x):
    dt = getattr(x, "dtype", None)
    if dt is None:
        return True
    try:
        return np.issubdtype(np.dtype(str(dt)), np.floating)
    except TypeError:
        return True     # extension dtypes (bfloat16): let jnp decide


@register_validator("block_diag")
def _block_diag(datas, attrs):
    # multiary.cc BlockDiagInferMeta — auto-wired: every input must be
    # at most 2-D (each block lands on the result diagonal)
    if not datas:
        _fail("block_diag", "block_diag expects at least one input")
    for i, d in enumerate(datas):
        if _ndim(d) > 2:
            _fail("block_diag",
                  f"Each input tensor can be 0-D, 1-D or 2-D, but "
                  f"input[{i}] has shape {list(_shape(d))}")


@register_validator("vander")
def _vander(datas, attrs):
    # unary.cc VanderInferMeta — auto-wired: 1-D input, non-negative
    # column count
    x = datas[0]
    if _ndim(x) != 1:
        _fail("vander",
              f"The input tensor must be 1-D, but received shape "
              f"{list(_shape(x))}")
    n = attrs.get("n")
    if n is not None and int(n) < 0:
        _fail("vander",
              f"The number of columns N should be non-negative, but "
              f"received {n}")


@register_validator("corrcoef")
def _corrcoef(datas, attrs):
    # unary.cc CorrcoefInferMeta — host-path wrapper, validated
    # manually in linalg.corrcoef: observations as a vector or matrix
    x = datas[0]
    if _ndim(x) > 2:
        _fail("corrcoef",
              f"The input tensor must be 1-D or 2-D, but received "
              f"shape {list(_shape(x))}")
    if not _float_dtype(x):
        _fail("corrcoef",
              f"The input must be a floating dtype, got "
              f"{getattr(x, 'dtype', None)}")


@register_validator("cov")
def _cov(datas, attrs):
    # multiary.cc CovInferMeta — host-path wrapper, validated manually
    # in linalg.cov: 1-D/2-D observations; each weights vector must be
    # 1-D with one entry per observation
    x = datas[0]
    xs = _shape(x)
    if len(xs) > 2:
        _fail("cov",
              f"The input tensor must be 1-D or 2-D, but received "
              f"shape {list(xs)}")
    rowvar = bool(attrs.get("rowvar", True))
    if len(xs) <= 1:
        nobs = xs[0] if xs else 1
    else:
        nobs = xs[1] if rowvar else xs[0]
    for name in ("fweights", "aweights"):
        w = attrs.get(name)
        if w is None:
            continue
        ws = _shape(w)
        if len(ws) != 1:
            _fail("cov",
                  f"The {name} tensor must be 1-D, but received shape "
                  f"{list(ws)}")
        if ws[0] != nobs:
            _fail("cov",
                  f"The length of {name} ({ws[0]}) should match the "
                  f"number of observations ({nobs})")


@register_validator("cauchy_")
def _cauchy_(datas, attrs):
    # unary.cc CauchyInferMeta — in-place fill, validated manually in
    # random.cauchy_: floating destination, positive scale
    x = datas[0]
    if not _float_dtype(x):
        _fail("cauchy_",
              f"The tensor to fill must be a floating dtype, got "
              f"{getattr(x, 'dtype', None)}")
    scale = attrs.get("scale", 1)
    if not float(scale) > 0:
        _fail("cauchy_",
              f"The scale parameter should be positive, but received "
              f"{scale}")


@register_validator("geometric_")
def _geometric_(datas, attrs):
    # unary.cc GeometricInferMeta — in-place fill, validated manually
    # in random.geometric_: floating destination, success probability
    # strictly inside (0, 1)
    x = datas[0]
    if not _float_dtype(x):
        _fail("geometric_",
              f"The tensor to fill must be a floating dtype, got "
              f"{getattr(x, 'dtype', None)}")
    probs = attrs.get("probs")
    if probs is not None and np.ndim(probs) == 0 \
            and not 0.0 < float(probs) < 1.0:
        _fail("geometric_",
              f"The probs parameter should be in the open interval "
              f"(0, 1), but received {probs}")


# -- batch 15: broadcast-shaping + dedup + distribution draws -----------------


@register_validator("expand_as")
def _expand_as(datas, attrs):
    # binary.cc ExpandAsInferMeta: the source rank must not exceed the
    # target's, and every source dim must equal the right-aligned
    # target dim or be 1 (otherwise the failure is a jnp broadcast
    # error deep inside expand's dispatch)
    xs = _shape(datas[0])
    ts = tuple(int(d) for d in attrs.get("target_shape", ()))
    if len(xs) > len(ts):
        _fail("expand_as",
              f"The rank of Input(X) {list(xs)} must not be greater "
              f"than the rank of Input(Y) {list(ts)}")
    for i in range(1, len(xs) + 1):
        if xs[-i] != ts[-i] and xs[-i] != 1:
            _fail("expand_as",
                  f"The value of the non-singleton dimension {len(ts) - i} "
                  f"of Input(X) ({xs[-i]}) must match Input(Y) "
                  f"({ts[-i]}); X'shape: {list(xs)}, Y'shape: {list(ts)}")


@register_validator("chunk")
def _chunk(datas, attrs):
    # unary.cc SplitWithNumInferMeta (chunk == split by count): a
    # positive chunk count, an in-range axis, and an axis extent the
    # count divides evenly
    xs = _shape(datas[0])
    chunks = int(attrs.get("chunks", 0))
    if chunks <= 0:
        _fail("chunk",
              f"Attr(chunks) should be greater than 0, but received "
              f"{chunks}")
    axis = _axis_in("chunk", int(attrs.get("axis", 0)), len(xs))
    if xs[axis] % chunks:
        _fail("chunk",
              f"The input's size along the split dimension must be "
              f"evenly divisible by Attr(chunks), but received "
              f"input shape {list(xs)}, axis {axis} and chunks {chunks}")


@register_validator("unique_consecutive")
def _unique_consecutive(datas, attrs):
    # unary.cc UniqueConsecutiveInferMeta: the index dtype attr is
    # int32/int64 only, and the axis (when given) must be in rank range
    xs = _shape(datas[0])
    dtype = str(attrs.get("dtype", "int64")).replace("paddle.", "")
    if dtype not in ("int32", "int64"):
        _fail("unique_consecutive",
              f"The dtype of attr(dtype) should be int32 or int64, "
              f"but got {dtype}")
    axis = attrs.get("axis")
    if axis is not None:
        _axis_in("unique_consecutive", int(axis), max(len(xs), 1))


@register_validator("poisson")
def _poisson(datas, attrs):
    # unary.cc PoissonInferMeta: the rate tensor must be floating
    if not _float_dtype(datas[0]):
        _fail("poisson",
              f"The rate tensor must be a floating dtype, got "
              f"{getattr(datas[0], 'dtype', None)}")


@register_validator("exponential_")
def _exponential_(datas, attrs):
    # unary.cc ExponentialInferMeta — in-place fill: floating
    # destination, strictly positive rate
    if not _float_dtype(datas[0]):
        _fail("exponential_",
              f"The tensor to fill must be a floating dtype, got "
              f"{getattr(datas[0], 'dtype', None)}")
    lam = attrs.get("lam", 1.0)
    if not float(lam) > 0:
        _fail("exponential_",
              f"The lam parameter should be positive, but received "
              f"{lam}")


@register_validator("log_normal_")
def _log_normal_(datas, attrs):
    # unary.cc LogNormalInferMeta — in-place fill: floating
    # destination, strictly positive std of the underlying normal
    if not _float_dtype(datas[0]):
        _fail("log_normal_",
              f"The tensor to fill must be a floating dtype, got "
              f"{getattr(datas[0], 'dtype', None)}")
    std = attrs.get("std", 2.0)
    if not float(std) > 0:
        _fail("log_normal_",
              f"The std parameter should be positive, but received "
              f"{std}")


@register_validator("binomial")
def _binomial(datas, attrs):
    # binary.cc BinomialInferMeta: count and prob are drawn
    # elementwise, so their shapes must match exactly
    cs, ps = _shape(datas[0]), _shape(datas[1])
    if cs != ps:
        _fail("binomial",
              f"Input(count) and Input(prob) should have the same "
              f"shape, but received count's shape {list(cs)} and "
              f"prob's shape {list(ps)}")

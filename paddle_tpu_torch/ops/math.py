"""Elementwise and scalar math ops of the port.

Counterpart of ``paddle_tpu/ops/math.py``.  Each op computes in the dtype
``jax.numpy`` gives it under x64 (``core.dtype.result_type``: an int32
tensor plus a Python float is float64, a float32 tensor plus a numpy
float64 scalar is float64), then calls torch.  Broadcasting gradients
reduce over the broadcast axes through torch's autograd; ``maximum`` and
``minimum`` give a tie's whole gradient to ``x``, as the reference's
hand-written backward does.
"""
from __future__ import annotations

import numbers

import numpy as np
import torch

from ..core import dtype as D
from ..device import resolve_device


def _device_of(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return resolve_device(None)


def _as(a, dt, dev):
    """``a`` as a tensor of ``dt`` on ``dev``; Python scalars stay
    scalars (torch keeps a tensor's dtype against them)."""
    if isinstance(a, torch.Tensor):
        if a.device != dev and a.dim() == 0:
            a = a.to(dev)
        return a if a.dtype == dt else a.to(dt)
    if isinstance(a, (np.ndarray, np.generic)):
        from ..core.tensor import numpy_to_torch

        return numpy_to_torch(np.asarray(a)).to(device=dev, dtype=dt)
    if isinstance(a, (list, tuple)):
        return torch.as_tensor(np.asarray(a)).to(device=dev, dtype=dt)
    return a


def prep(*args, inexact=False, dtype=None):
    """``args`` cast to their common dtype (``jax.numpy``'s promotion,
    or ``dtype``); with ``inexact`` integers and bool go to float as
    jax's ``promote_args_inexact`` sends them.  At least the first
    argument comes back a tensor."""
    dt = dtype or D.result_type(*args)
    if inexact:
        dt = D.to_inexact(dt)
    dev = _device_of(args)
    out = [_as(a, dt, dev) for a in args]
    if not any(isinstance(o, torch.Tensor) for o in out):
        out[0] = torch.tensor(out[0], dtype=dt, device=dev)
    return out


def _binary(name, fn, inexact=False):
    def api(x, y, out=None, name=None):
        a, b = prep(x, y, inexact=inexact)
        if not isinstance(a, torch.Tensor):
            a = torch.full_like(b, a)
        return fn(a, b)

    api.__name__ = name
    return api


class _MaxMin(torch.autograd.Function):
    """``maximum`` / ``minimum`` with the reference's backward: the mask
    ``x >= y`` (``x <= y``) sends a tie's whole gradient to ``x``."""

    @staticmethod
    def forward(ctx, x, y, is_max):
        out = torch.maximum(x, y) if is_max else torch.minimum(x, y)
        ctx.save_for_backward(x, y)
        ctx.is_max = is_max
        return out

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        mask = (x >= y) if ctx.is_max else (x <= y)
        gx = torch.where(mask, g, torch.zeros_like(g))
        gy = g - gx
        return _unbroadcast(gx, x.shape), _unbroadcast(gy, y.shape), None


def _unbroadcast(g, shape):
    """Sum ``g`` down to ``shape`` (the reverse of broadcasting)."""
    if g.shape == shape:
        return g
    extra = g.dim() - len(shape)
    if extra > 0:
        g = g.sum(dim=tuple(range(extra)))
    axes = tuple(i for i, s in enumerate(shape) if s == 1 and g.shape[i] != 1)
    if axes:
        g = g.sum(dim=axes, keepdim=True)
    return g.reshape(shape)


def _maxmin(is_max):
    def api(x, y, name=None):
        a, b = prep(x, y)
        a = a if isinstance(a, torch.Tensor) else torch.full_like(b, a)
        b = b if isinstance(b, torch.Tensor) else torch.full_like(a, b)
        if a.is_floating_point() and torch.is_grad_enabled() and (
                a.requires_grad or b.requires_grad):
            return _MaxMin.apply(a, b, is_max)
        return torch.maximum(a, b) if is_max else torch.minimum(a, b)

    api.__name__ = "maximum" if is_max else "minimum"
    return api


add = _binary("add", torch.add)
subtract = _binary("subtract", torch.sub)
multiply = _binary("multiply", torch.mul)
divide = _binary("divide", torch.true_divide, inexact=True)
maximum = _maxmin(True)
minimum = _maxmin(False)


pow = _binary("pow", torch.pow)  # noqa: A001 - paddle API name
remainder = _binary("remainder", torch.remainder)
mod = remainder
floor_mod = remainder
floor_divide = _binary("floor_divide", torch.floor_divide)
fmax = _binary("fmax", torch.fmax)
fmin = _binary("fmin", torch.fmin)
logaddexp = _binary("logaddexp", torch.logaddexp, inexact=True)
atan2 = _binary("atan2", torch.atan2, inexact=True)
gcd = _binary("gcd", torch.gcd)
lcm = _binary("lcm", torch.lcm)
bitwise_and = _binary("bitwise_and", torch.bitwise_and)
bitwise_or = _binary("bitwise_or", torch.bitwise_or)
bitwise_xor = _binary("bitwise_xor", torch.bitwise_xor)
left_shift = _binary("left_shift", torch.bitwise_left_shift)
right_shift = _binary("right_shift", torch.bitwise_right_shift)


# -- unary ops --------------------------------------------------------------

def _unary(name, fn, kind="inexact"):
    """``kind``: "inexact" (integers and bool to float first, as jax's
    ``promote_args_inexact``), "keep" (the input dtype), "numeric" (bool
    to int32 first), "int_id" (integer and bool inputs come back as they
    are: ``floor`` and the like), "int_zero" (they come back zero:
    ``frac``) or "bool_id" (bool comes back as it is: ``abs``)."""
    def api(x, name=None):
        (x,) = prep(x)
        exact = not (x.is_floating_point() or x.is_complex())
        if kind == "inexact":
            x = x.to(D.to_inexact(x.dtype))
        elif kind == "numeric":
            x = x.to(D.to_numeric(x.dtype))
        elif kind == "int_id" and exact:
            return x.clone()
        elif kind == "int_zero" and exact:
            return torch.zeros_like(x)
        elif kind == "bool_id" and x.dtype == torch.bool:
            return x.clone()
        return fn(x)

    api.__name__ = name
    return api


exp = _unary("exp", torch.exp)
expm1 = _unary("expm1", torch.expm1)
log = _unary("log", torch.log)
log2 = _unary("log2", torch.log2)
log10 = _unary("log10", torch.log10)
log1p = _unary("log1p", torch.log1p)
sqrt = _unary("sqrt", torch.sqrt)
rsqrt = _unary("rsqrt", torch.rsqrt)
square = _unary("square", torch.square, "numeric")
abs = _unary("abs", torch.abs, "bool_id")  # noqa: A001
neg = _unary("neg", torch.neg, "keep")
negative = neg
sign = _unary("sign", torch.sign, "keep")
floor = _unary("floor", torch.floor, "int_id")
ceil = _unary("ceil", torch.ceil, "int_id")
round_ = _unary("round", torch.round, "int_id")
trunc = _unary("trunc", torch.trunc, "int_id")
frac = _unary("frac", lambda x: x - torch.trunc(x), "int_zero")
reciprocal = _unary("reciprocal", torch.reciprocal)
sin = _unary("sin", torch.sin)
cos = _unary("cos", torch.cos)
tan = _unary("tan", torch.tan)
asin = _unary("asin", torch.asin)
acos = _unary("acos", torch.acos)
atan = _unary("atan", torch.atan)
sinh = _unary("sinh", torch.sinh)
cosh = _unary("cosh", torch.cosh)
asinh = _unary("asinh", torch.asinh)
acosh = _unary("acosh", torch.acosh)
atanh = _unary("atanh", torch.atanh)
erf = _unary("erf", torch.special.erf)
erfinv = _unary("erfinv", torch.special.erfinv)
lgamma = _unary("lgamma", torch.lgamma)
digamma = _unary("digamma", torch.special.digamma)
bitwise_not = _unary("bitwise_not", torch.bitwise_not, "keep")
isnan = _unary("isnan", torch.isnan, "keep")
isinf = _unary("isinf", torch.isinf, "keep")
isfinite = _unary("isfinite", torch.isfinite, "keep")
logical_not = _unary("logical_not", torch.logical_not, "keep")
i0 = _unary("i0", torch.special.i0)
rint = _unary("rint", torch.round, "int_id")

logical_and = _binary("logical_and", torch.logical_and)
logical_or = _binary("logical_or", torch.logical_or)
logical_xor = _binary("logical_xor", torch.logical_xor)
equal = _binary("equal", torch.eq)
not_equal = _binary("not_equal", torch.ne)
greater_than = _binary("greater_than", torch.gt)
greater_equal = _binary("greater_equal", torch.ge)
less_than = _binary("less_than", torch.lt)
less_equal = _binary("less_equal", torch.le)


# -- clip / scale / lerp ----------------------------------------------------

def _scalar(v):
    if isinstance(v, torch.Tensor):
        return float(v.item())
    return float(v) if isinstance(v, numbers.Number) else v


def clip(x, min=None, max=None, name=None):  # noqa: A002
    """``jnp.clip`` with float bounds: the bounds are Python floats, so
    an integer ``x`` comes back float64 as in the reference."""
    min = _scalar(min) if min is not None else None  # noqa: A001
    max = _scalar(max) if max is not None else None  # noqa: A001
    bounds = [v for v in (min, max) if v is not None]
    (x,) = prep(x, dtype=D.result_type(x, *bounds))
    return torch.clamp(x, min, max)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    s, b = _scalar(scale), _scalar(bias)
    (x,) = prep(x, dtype=D.result_type(x, s, b))
    if bias_after_scale:
        return x * s + b
    return (x + b) * s


def lerp(x, y, weight, name=None):
    x, y, w = prep(x, y, weight)
    return x + w * (y - x)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    (x,) = prep(x, dtype=D.result_type(x, scale_a, scale_b))
    x = x.to(D.to_inexact(x.dtype))
    return scale_b * torch.tanh(x * scale_a)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    (x,) = prep(x)
    if not (x.is_floating_point() or x.is_complex()):
        return x.clone()
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)

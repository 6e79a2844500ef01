"""In-place op variants (``paddle.abs_(x)``, ``paddle.add_(x, y)``).

Counterpart of ``paddle_tpu/ops/inplace.py``.  The reference computes the
functional result and rebinds it into the same Tensor object, so the
object can change dtype (an int tensor that takes a float operand, a
comparison) or shape (``reshape_``).  Here the same object is returned
holding the functional result, in the functional result's dtype and
shape:

* a result of x's dtype and shape is written into x's storage
  (``copy_``), so views and captured addresses of x see it;
* any other result replaces x's storage (``x.data = out``);
* under autograd (grad mode on and x or an operand requiring grad) the
  result is computed from a copy of x and written with ``copy_``, so x's
  history is the op's; a result of another dtype or shape, or a leaf
  that requires grad, raises there, as torch's own in-place ops do.

The torch methods of the same names (``Tensor.add_``) keep torch's
meaning; these are the flat functions of ``paddle_tpu_torch``.
"""
from __future__ import annotations

import torch

_UNARY = [
    "abs", "acos", "asin", "atan", "asinh", "acosh", "atanh", "ceil",
    "cos", "cosh", "digamma", "erf", "exp", "expm1", "floor", "frac",
    "lgamma", "log", "log10", "log1p", "log2", "logical_not", "neg",
    "reciprocal", "rsqrt", "sigmoid", "sin", "sinh", "sqrt", "square",
    "tan", "tanh", "trunc", "i0", "sinc", "logit", "nan_to_num",
    "bitwise_not", "gammaln", "sgn",
]
_BINARY = [
    "add", "subtract", "multiply", "divide", "remainder", "mod",
    "floor_divide", "floor_mod", "pow", "bitwise_and", "bitwise_or",
    "bitwise_xor", "logical_and", "logical_or", "logical_xor",
    "equal", "not_equal", "greater_than", "greater_equal", "less_than",
    "less_equal", "gcd", "lcm", "copysign", "hypot", "ldexp",
    "nextafter", "gammainc", "gammaincc", "atan2", "fmax", "fmin",
    "maximum", "minimum", "bitwise_left_shift", "bitwise_right_shift",
]
_OTHER = [
    "clip", "scale", "lerp", "cumsum", "cumprod", "renorm", "round",
    "masked_fill", "masked_scatter", "index_add", "index_fill", "scatter",
    "put_along_axis", "tril", "triu", "reshape", "flatten", "squeeze",
    "unsqueeze", "transpose", "t", "cast", "multigammaln", "polygamma",
    "multiply", "addmm", "erfinv",
]


def _needs_grad(args):
    return torch.is_grad_enabled() and any(
        isinstance(a, torch.Tensor) and a.requires_grad for a in args)


def rebind(x, out, tracked):
    """Make ``x`` hold ``out`` (see the module docstring); returns x."""
    if tracked and out.requires_grad:
        if out.dtype != x.dtype or out.shape != x.shape:
            raise RuntimeError(
                "an in-place op that changes dtype or shape cannot be "
                "recorded by autograd; detach x or call the functional op")
        return x.copy_(out)
    if out.dtype == x.dtype and out.shape == x.shape:
        if out.untyped_storage().data_ptr() == \
                x.untyped_storage().data_ptr():
            out = out.clone()
        with torch.no_grad():
            return x.copy_(out)
    x.data = out
    return x


def _make_inplace(fn, func_name):
    def _inplace(x, *args, **kwargs):
        if not isinstance(x, torch.Tensor):
            raise TypeError(
                f"{func_name}_ requires a tensor, got {type(x)}")
        tracked = _needs_grad((x,) + args + tuple(kwargs.values()))
        out = fn(x.clone() if tracked else x, *args, **kwargs)
        return rebind(x, out, tracked)

    _inplace.__name__ = func_name + "_"
    _inplace.__doc__ = f"In-place variant of ``{func_name}``."
    return _inplace


def where_(condition, x, y, name=None):
    """paddle.where_: writes the ``where`` result into ``x`` (the second
    argument)."""
    from .manipulation import where

    tracked = _needs_grad((x, y))
    out = where(condition, x.clone() if tracked else x, y)
    return rebind(x, out, tracked)


def install(namespace):
    """Every ``<op>_`` wrapper whose functional op exists in
    ``namespace``: {name: function}."""
    created = {"where_": where_}
    for name in dict.fromkeys(_UNARY + _BINARY + _OTHER):
        fn = getattr(namespace, name, None)
        if fn is not None:
            created[name + "_"] = _make_inplace(fn, name)
    return created

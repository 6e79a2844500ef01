"""Ops of the port: the flat functional op namespace (``paddle.add``,
``paddle.matmul``, ...) over torch tensors, the plain PyTorch versions
of the model paths' ops (``nn_ops``), int8 quantization (``quant``) and
the hand-written kernels (``kernels``).

Counterpart of ``paddle_tpu/ops/__init__.py`` for the families ported so
far: ``math``, ``reduction``, ``manipulation``, ``creation``,
``activation``, ``random``, ``linalg.matmul``, the in-place variants
(``inplace``) and the names this module defines itself.
"""
from __future__ import annotations

import builtins as _bi
import sys as _sys
import types as _types

import torch as _torch

from .kernels.grouped_gemm import grouped_ffn  # noqa: F401
from . import inplace as _inplace_mod
from .math import prep as _prep

from .math import (  # noqa: F401
    add, subtract, multiply, divide, pow, maximum, minimum, remainder, mod,
    floor_divide, floor_mod, fmax, fmin, logaddexp, atan2, gcd, lcm,
    bitwise_and, bitwise_or, bitwise_xor, left_shift, right_shift,
    exp, expm1, log, log2, log10, log1p, sqrt, rsqrt, square, abs, neg,
    negative, sign, floor, ceil, trunc, frac, reciprocal, sin, cos,
    tan, asin, acos, atan, sinh, cosh, asinh, acosh, atanh, erf, erfinv,
    lgamma, digamma, bitwise_not, logical_not,
    logical_and, logical_or, logical_xor, equal, not_equal, greater_than,
    greater_equal, less_than, less_equal, clip, scale, lerp, stanh,
    nan_to_num, i0, rint, isnan, isinf, isfinite,
)
from .reduction import (  # noqa: F401
    sum, mean, max, min, amax, amin, prod, any, all, logsumexp, argmax,
    argmin, cumsum, cumprod, cummax, cummin, var, std, numel, count_nonzero,
    nanmean, nansum, median, quantile,
)
from .manipulation import (  # noqa: F401
    cast, reshape, transpose, t, squeeze, unsqueeze, flatten, expand,
    broadcast_to, expand_as, broadcast_shape, tile, concat, stack, split,
    chunk, unstack, unbind, flip, roll, pad, gather, index_select,
    take_along_axis, put_along_axis, scatter, scatter_nd_add, gather_nd,
    where, nonzero, masked_select, masked_fill, topk, sort, argsort, unique,
    unique_consecutive, assign, tril, triu, diag, diagonal,
    repeat_interleave, one_hot, meshgrid, moveaxis, view, slice, getitem,
    setitem,
)
from .linalg import matmul  # noqa: F401
from .creation import (  # noqa: F401
    zeros, ones, full, empty, zeros_like, ones_like, full_like, empty_like,
    arange, linspace, logspace, eye, diag_embed, clone, to_tensor, complex,
    as_complex, as_real,
)
from .random import (  # noqa: F401
    seed, get_rng_state, set_rng_state, randn, standard_normal, normal,
    gaussian, rand, uniform, randint, randint_like, randperm, bernoulli,
    poisson, multinomial, normal_, uniform_, exponential_, bernoulli_,
    cauchy_, geometric_, log_normal_, log_normal, standard_gamma, binomial,
)
from .activation import (  # noqa: F401
    relu, relu6, sigmoid, tanh, silu, gelu, leaky_relu, elu, selu, celu,
    softplus, softsign, hardtanh, hardsigmoid, hardswish, swish, mish,
    tanhshrink, softshrink, hardshrink, thresholded_relu, log_sigmoid,
    prelu, glu, swiglu, softmax, log_softmax,
)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    """A 0-d bool tensor: ``np.allclose`` of the two, on x's device."""
    a, b = _prep(x, y)
    ok = _torch.allclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan)
    return _torch.tensor(ok, device=a.device)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    a, b = _prep(x, y)
    return _torch.isclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan)


def equal_all(x, y, name=None):
    """A 0-d bool tensor: the shapes and every value agree."""
    a, b = _prep(x, y)
    ok = a.shape == b.shape and _bi.bool((a == b).all())
    return _torch.tensor(ok, device=a.device)


def increment(x, value=1.0, name=None):
    """``x += value`` in x's dtype, in place; returns x."""
    with _torch.no_grad():
        x.copy_(add(x, _torch.tensor(value, dtype=x.dtype,
                                     device=x.device)))
    return x


def _install_inplace_variants():
    mod = _sys.modules[__name__]
    created = _inplace_mod.install(mod)
    for name, fn in created.items():
        if not hasattr(mod, name):
            setattr(mod, name, fn)
    return sorted(created)


_INPLACE_VARIANTS = _install_inplace_variants()

#: what ``from paddle_tpu_torch.ops import *`` puts into the flat
#: namespace: the families' ops, this module's own and the in-place
#: variants (not the submodules, nor the kernel wrapper ``grouped_ffn``)
__all__ = sorted(
    n for n, v in globals().items()
    if not n.startswith("_") and not isinstance(v, _types.ModuleType)
    and n not in ("annotations", "grouped_ffn"))

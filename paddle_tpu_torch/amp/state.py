"""AMP state and the per-op cast policy.  Counterpart of
``paddle_tpu/amp/state.py``: the same white and black lists, the same
state (enabled, level, dtype, custom lists) and ``amp_transform``, which
casts an op's floating inputs as the policy says.

The policy is applied by the op registry's one dispatch wrapper
(``ops/registry.py``): the port's named ops (``@dispatch(name)``) cast
their positional tensor arguments by their name and run their body with
the policy suspended (:func:`no_amp`: nothing inside is cast again, as
no cast reaches the reference's jnp op bodies); plain torch arithmetic
between them (``+``, ``reshape``, ``cat``, ``mean``, ...) is seen by the
registry's ``DispatchMode``, which maps each torch function to the
reference's op name (``_TORCH_NAMES``) and casts its inputs by that
name.  Functions it does not know (``Tensor.to``, ``size``, in-place
updates) pass through as they are, as the reference's ``cast`` and
``assign`` do.

Gradients are never cast (the reference's grad ops skip the policy):
the mode passes everything through while autograd runs a backward.
Code that the reference writes as raw jnp (the optimizers' updates, the
running-statistics update, the scaler's unscale) runs under
:func:`no_amp`.
"""
from __future__ import annotations

import contextlib

import torch

# Ops that run in low precision under O1 (matmul-class ops).
WHITE_LIST = {
    "matmul", "conv2d", "conv1d", "conv2d_transpose", "einsum", "addmm",
    "scaled_dot_product_attention", "bmm", "mm",
}

# Ops that must stay fp32 (numerically sensitive).
BLACK_LIST = {
    "exp", "log", "log2", "log10", "log1p", "logsumexp",
    "softmax_with_cross_entropy", "cross_entropy", "reduce_mean",
    "reduce_sum", "layer_norm", "rms_norm", "fused_rms_norm", "group_norm",
    "batch_norm_stats",
    "batch_norm_infer", "softmax", "log_softmax", "erf", "erfinv",
    "reciprocal", "rsqrt", "pow", "elementwise_pow", "cumsum", "cumprod",
}

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


class _AmpState:
    __slots__ = ("enabled", "level", "dtype", "custom_white", "custom_black",
                 "depth", "tally")

    def __init__(self):
        self.enabled = False
        self.level = "O0"
        self.dtype = "bfloat16"
        self.custom_white = set()
        self.custom_black = set()
        self.depth = 0        # > 0 inside a named op or under no_amp
        self.tally = None     # {(op, dtype): calls} while stats are on


_state = _AmpState()


def amp_state() -> _AmpState:
    return _state


def amp_enabled() -> bool:
    return _state.enabled


def amp_level() -> str:
    return _state.level if _state.enabled else "O0"


def to_dtype(dtype) -> torch.dtype:
    """A torch dtype from a name (``"bfloat16"``) or a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _DTYPES[str(dtype).replace("paddle.", "")]


def amp_dtype() -> torch.dtype:
    return to_dtype(_state.dtype)


def target(op_name):
    """The dtype the policy casts ``op_name``'s floating inputs to, or
    ``None`` (left as they are)."""
    if op_name in ("cast", "assign"):
        return None
    white = (WHITE_LIST | _state.custom_white) - _state.custom_black
    in_black = op_name in (BLACK_LIST | _state.custom_black)
    if _state.level == "O2":
        return torch.float32 if in_black else amp_dtype()
    if op_name in white:
        return amp_dtype()
    return torch.float32 if in_black else None


def _cast_one(t, target):
    if isinstance(t, torch.Tensor) and t.is_floating_point() \
            and t.dtype != target:
        from . import _cast_cache

        return _cast_cache.cached_cast(t, target)
    return t


def cast_arg(a, target):
    """A tensor, or a plain list or tuple of them (``torch.cat``'s
    operands), cast as :func:`_cast_one` casts."""
    if type(a) in (list, tuple):
        return type(a)(_cast_one(t, target) for t in a)
    return _cast_one(a, target)


def amp_transform(op_name: str, tensors):
    """Cast op inputs per policy (the reference's ``amp_transform``):
    each floating tensor of ``tensors`` (or of a list or tuple among
    them) whose dtype differs from the target goes through the cast
    cache; other values pass as they are."""
    if not _state.enabled:
        return tensors
    target_ = target(op_name)
    if target_ is None:
        return tensors
    return tuple(cast_arg(t, target_) for t in tensors)


def record(op_name, out):
    """Tally one call of ``op_name``: +1 per tensor output, keyed by
    (op, output dtype name), as the reference's operator statistics."""
    outs = out if isinstance(out, (tuple, list)) else (out,)
    for o in outs:
        if isinstance(o, torch.Tensor):
            k = (op_name, str(o.dtype).replace("torch.", ""))
            _state.tally[k] = _state.tally.get(k, 0) + 1


def cast(t, dtype):
    """``t.to(dtype)`` as the reference's ``cast`` op (never cast by the
    policy itself; tallied as ``cast`` when it copies)."""
    if t.dtype == dtype:
        return t
    out = t.to(dtype)
    if _state.tally is not None:
        record("cast", out)
    return out


@contextlib.contextmanager
def op_dtypes():
    """Tally ``(op name, output dtype)`` of every op the dispatch sees
    while the block runs (what ``amp.debugging.collect_operator_stats``
    prints).  Yields the dict it fills."""
    from ..ops import registry

    prev, _state.tally = _state.tally, {}
    registry.acquire_mode()
    try:
        yield _state.tally
    finally:
        registry.release_mode()
        _state.tally = prev


@contextlib.contextmanager
def no_amp():
    """Run a block as the reference runs raw jnp code: no cast, no
    interception (torch function handling off, named ops plain)."""
    _state.depth += 1
    try:
        with torch._C.DisableTorchFunction():
            yield
    finally:
        _state.depth -= 1


# torch function name -> the reference's op name.  In-place variants are
# left out on purpose: casting the tensor an in-place op writes would
# write a copy.
_TORCH_NAMES = {
    "add": "add", "__add__": "add", "__radd__": "add",
    "sub": "subtract", "subtract": "subtract", "__sub__": "subtract",
    "__rsub__": "subtract", "rsub": "subtract",
    "mul": "multiply", "multiply": "multiply", "__mul__": "multiply",
    "__rmul__": "multiply",
    "div": "divide", "divide": "divide", "true_divide": "divide",
    "__truediv__": "divide", "__rtruediv__": "divide",
    "__div__": "divide", "__rdiv__": "divide",
    "matmul": "matmul", "__matmul__": "matmul", "__rmatmul__": "matmul",
    "mm": "mm", "bmm": "bmm", "addmm": "addmm", "einsum": "einsum",
    "linear": "matmul",
    "reshape": "reshape", "view": "reshape", "flatten": "reshape",
    "cat": "concat", "concat": "concat", "concatenate": "concat",
    "stack": "stack", "transpose": "transpose", "permute": "transpose",
    "__getitem__": "slice", "squeeze": "squeeze", "unsqueeze": "unsqueeze",
    "expand": "expand", "split": "split", "chunk": "chunk",
    "relu": "relu", "relu6": "relu6", "hardswish": "hardswish",
    "hardsigmoid": "hardsigmoid", "silu": "silu", "sigmoid": "sigmoid",
    "tanh": "tanh", "gelu": "gelu", "leaky_relu": "leaky_relu",
    "abs": "abs", "neg": "neg", "negative": "neg", "__neg__": "neg",
    "exp": "exp", "log": "log", "log1p": "log1p", "log2": "log2",
    "log10": "log10", "logsumexp": "logsumexp", "sqrt": "sqrt",
    "square": "square", "rsqrt": "rsqrt", "reciprocal": "reciprocal",
    "erf": "erf", "erfinv": "erfinv", "pow": "elementwise_pow",
    "__pow__": "elementwise_pow", "__rpow__": "elementwise_pow",
    "mean": "reduce_mean", "sum": "reduce_sum", "cumsum": "cumsum",
    "cumprod": "cumprod", "softmax": "softmax", "log_softmax": "log_softmax",
    "maximum": "maximum", "minimum": "minimum", "clamp": "clip",
    "clip": "clip", "where": "where",
    "max_pool2d": "max_pool2d", "avg_pool2d": "avg_pool2d",
    "adaptive_avg_pool2d": "adaptive_avg_pool2d",
    "conv2d": "conv2d",
}

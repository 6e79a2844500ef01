"""Activation ops of the port.

Counterpart of ``paddle_tpu/ops/activation.py`` and of the functional
wrappers that ``paddle_tpu/ops/__init__.py`` defines over it (``relu``,
``softmax``, ...); ``paddle_tpu_torch.nn.functional`` re-exports them, as
the reference's ``nn.functional`` re-exports its ``ops``.  Each is the
reference's ``jax.numpy`` expression written in torch, so the rounding
points agree, and each is the reference's registered op under AMP
(``amp_op``).  Gradients come from torch's autograd, except where the
reference's op has a hand-written backward that differs from autograd
on a boundary: ``relu6`` (``hardtanh``'s mask, 0 < x < 6), ``hardswish``
(0 at x <= -3, 1 at x >= 3); ``hardtanh`` and ``hardsigmoid`` clip as
``jnp.clip`` does, through ``maximum`` and ``minimum``, so a value on a
bound takes half the gradient there, as in the reference.  ``gelu``,
``silu``, ``swiglu`` and ``softmax`` are the ones the model paths
already use (``ops/nn_ops.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..amp.state import amp_op
from . import nn_ops
from .math import prep


def _x(x):
    if isinstance(x, torch.Tensor):
        return x
    (x,) = prep(x)
    return x


def _jclip(x, lo, hi):
    """``jnp.clip(x, lo, hi)``: ``minimum(maximum(x, lo), hi)``, whose
    gradient on a tie is split in half, in torch as in jax."""
    x = torch.maximum(x, x.new_full((), lo))
    return torch.minimum(x, x.new_full((), hi))


@amp_op("relu")
def relu(x, name=None):
    return torch.relu(_x(x))


@amp_op("relu6")
def relu6(x, name=None):
    """``min(max(x, 0), 6)``; the gradient passes where 0 < x < 6, as the
    reference's hand-written one does (``hardtanh``'s backward)."""
    return F.hardtanh(_x(x), 0.0, 6.0)


@amp_op("sigmoid")
def sigmoid(x, name=None):
    return torch.sigmoid(_x(x))


@amp_op("tanh")
def tanh(x, name=None):
    return torch.tanh(_x(x))


def silu(x, name=None):
    return nn_ops.silu(_x(x))


@amp_op("swish")
def swish(x, name=None):
    """``x * sigmoid(x)`` (the reference's ``swish`` is ``jax.nn.silu``)."""
    x = _x(x)
    return x * torch.sigmoid(x)


def gelu(x, approximate=False, name=None):
    """GELU: the erf form, or the tanh form with ``approximate``."""
    return nn_ops.gelu(_x(x), approximate=bool(approximate))


@amp_op("leaky_relu")
def leaky_relu(x, negative_slope=0.01, name=None):
    x = _x(x)
    return torch.where(x >= 0, x, negative_slope * x)


@amp_op("elu")
def elu(x, alpha=1.0, name=None):
    x = _x(x)
    return torch.where(x > 0, x, alpha * torch.expm1(
        torch.where(x > 0, torch.zeros_like(x), x)))


@amp_op("selu")
def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    x = _x(x)
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


@amp_op("celu")
def celu(x, alpha=1.0, name=None):
    x = _x(x)
    return torch.where(x > 0, x, alpha * torch.expm1(x / alpha))


def _softplus0(x):
    return torch.logaddexp(x, torch.zeros_like(x))


@amp_op("softplus")
def softplus(x, beta=1.0, threshold=20.0, name=None):
    x = _x(x)
    return torch.where(x * beta > threshold, x,
                       _softplus0(x * beta) / beta)


@amp_op("softsign")
def softsign(x, name=None):
    x = _x(x)
    return x / (1 + torch.abs(x))


@amp_op("hardtanh")
def hardtanh(x, min=-1.0, max=1.0, name=None):  # noqa: A002
    return _jclip(_x(x), float(min), float(max))


@amp_op("hardsigmoid")
def hardsigmoid(x, slope=1 / 6, offset=0.5, name=None):
    """``clip(slope * x + offset, 0, 1)``."""
    return _jclip(slope * _x(x) + offset, 0.0, 1.0)


class _Hardswish(torch.autograd.Function):
    """``x * clip(x + 3, 0, 6) / 6``, in that order, in x's dtype; the
    reference's backward: 0 at x <= -3, 1 at x >= 3, (2x + 3) / 6
    between."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        d = torch.where(x <= -3, torch.zeros_like(x), torch.where(
            x >= 3, torch.ones_like(x), (2 * x + 3) / 6))
        return g * d


@amp_op("hardswish")
def hardswish(x, name=None):
    return _Hardswish.apply(_x(x))


@amp_op("mish")
def mish(x, name=None):
    x = _x(x)
    return x * torch.tanh(_softplus0(x))


@amp_op("tanhshrink")
def tanhshrink(x, name=None):
    x = _x(x)
    return x - torch.tanh(x)


@amp_op("softshrink")
def softshrink(x, threshold=0.5, name=None):
    x = _x(x)
    zero = torch.zeros_like(x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


@amp_op("hardshrink")
def hardshrink(x, threshold=0.5, name=None):
    x = _x(x)
    return torch.where(torch.abs(x) > threshold, x, torch.zeros_like(x))


@amp_op("thresholded_relu")
def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    x = _x(x)
    return torch.where(x > threshold, x, torch.full_like(x, value))


@amp_op("log_sigmoid")
def log_sigmoid(x, name=None):
    return F.logsigmoid(_x(x))


@amp_op("prelu")
def prelu(x, weight, data_format="NCHW", name=None):
    x, weight = prep(x, weight)
    if weight.dim() == 1 and weight.shape[0] > 1:
        shape = ((1, -1) + (1,) * (x.dim() - 2)) if data_format == "NCHW" \
            else ((1,) * (x.dim() - 1) + (-1,))
        weight = weight.reshape(shape)
    return torch.where(x >= 0, x, weight * x)


@amp_op("glu")
def glu(x, axis=-1, name=None):
    a, b = torch.chunk(_x(x), 2, dim=int(axis))
    return a * torch.sigmoid(b)


def swiglu(x, y=None, name=None):
    return nn_ops.swiglu(_x(x), None if y is None else _x(y))


def softmax(x, axis=-1, dtype=None, name=None):
    x = _x(x)
    if dtype is not None:
        from .manipulation import cast

        x = cast(x, dtype)
    return nn_ops.softmax(x, axis=int(axis))


@amp_op("log_softmax")
def log_softmax(x, axis=-1, dtype=None, name=None):
    x = _x(x)
    if dtype is not None:
        from .manipulation import cast

        x = cast(x, dtype)
    return torch.log_softmax(x, dim=int(axis))

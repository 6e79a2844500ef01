"""Parameter initializers.  Counterpart of ``paddle_tpu/nn/initializer.py``:
``Constant``, ``Normal``, ``TruncatedNormal``, ``Uniform``,
``XavierNormal`` / ``XavierUniform``, ``KaimingNormal`` /
``KaimingUniform``, ``Assign``, ``Orthogonal``, ``calculate_gain`` and
``set_global_initializer``, with the reference's fan rule (:func:`fans`).

An initializer fills a tensor in place: ``init(t, generator=None)``.
Draws are made in fp32 and cast to the tensor's dtype, as the reference
draws them, from ``generator`` (a ``torch.Generator`` on ``t``'s
device) or, without one, from the port's default generator of that
device (``ops.random.generator``, reseeded by ``paddle.seed``).  A
tensor on the ``meta`` device holds no values and is left as it is.
JAX's threefry stream is not Philox: the draws share the reference's
distributions, never its bits.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def fans(shape):
    """``(fan_in, fan_out)`` as ``paddle_tpu``'s ``_fans``: a 2-D weight is
    ``[in, out]``; from 3-D on the conv layout ``[out, in, *receptive]``
    applies, so a stacked expert weight ``[E, H, F]`` has fan_in ``H * F``
    and fan_out ``E * F``."""
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


def seeded_generator(device, seed=0):
    """A ``torch.Generator`` on ``device`` seeded with ``seed``; ``None``
    on the ``meta`` device, whose tensors hold no values (a model built
    there, to count its shapes, draws nothing)."""
    if torch.device(device).type == "meta":
        return None
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def _gen(t, generator):
    if generator is not None:
        return generator
    from ..ops.random import generator as default

    return default(t.device)


def _fp32(t):
    return torch.empty(t.shape, dtype=torch.float32, device=t.device)


@torch.no_grad()
def uniform_(t, low, high, generator=None):
    """Fill ``t`` in place from U(low, high), drawn in fp32."""
    if t.device.type == "meta":
        return t
    u = _fp32(t).uniform_(low, high, generator=_gen(t, generator))
    return t.copy_(u)


@torch.no_grad()
def normal_(t, mean, std, generator=None):
    """Fill ``t`` in place from N(mean, std²), drawn in fp32 as
    ``mean + std * z``."""
    if t.device.type == "meta":
        return t
    z = _fp32(t).normal_(0.0, 1.0, generator=_gen(t, generator))
    return t.copy_(mean + std * z)


@torch.no_grad()
def xavier_uniform_(t, generator=None, gain=1.0):
    """Fill ``t`` in place from U(-limit, limit), ``limit = gain *
    sqrt(6 / (fan_in + fan_out))``."""
    fi, fo = fans(t.shape)
    limit = gain * math.sqrt(6.0 / (fi + fo))
    return uniform_(t, -limit, limit, generator)


@torch.no_grad()
def zeros_(t):
    """Fill ``t`` with zeros (the bias default)."""
    return t.zero_()


class Initializer:
    """Base class: ``init(t, generator=None)`` fills ``t`` in place and
    returns it."""

    def __call__(self, t, generator=None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    @torch.no_grad()
    def __call__(self, t, generator=None):
        return t.fill_(self.value)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, t, generator=None):
        return normal_(t, self.mean, self.std, generator)


class TruncatedNormal(Initializer):
    """``mean + std * z`` with z from the standard normal cut to
    ``[a, b]`` (the reference's bounds are in units of ``std``), drawn
    by the inverse CDF of a uniform on ``[Φ(a), Φ(b)]``."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    @torch.no_grad()
    def __call__(self, t, generator=None):
        if t.device.type == "meta":
            return t
        cdf = lambda v: 0.5 * (1.0 + math.erf(v / math.sqrt(2.0)))  # noqa
        u = _fp32(t).uniform_(2 * cdf(self.a) - 1, 2 * cdf(self.b) - 1,
                              generator=_gen(t, generator))
        z = (torch.erfinv(u) * math.sqrt(2.0)).clamp_(self.a, self.b)
        return t.copy_(self.mean + self.std * z)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, t, generator=None):
        return uniform_(t, self.low, self.high, generator)


class _Fans(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self._fan_in, self._fan_out, self.gain = fan_in, fan_out, gain

    def _fans(self, shape):
        fi, fo = fans(shape)
        return (self._fan_in if self._fan_in is not None else fi,
                self._fan_out if self._fan_out is not None else fo)


class XavierNormal(_Fans):
    """N(0, std²), ``std = gain * sqrt(2 / (fan_in + fan_out))``."""

    def __call__(self, t, generator=None):
        fi, fo = self._fans(t.shape)
        return normal_(t, 0.0, self.gain * math.sqrt(2.0 / (fi + fo)),
                       generator)


class XavierUniform(_Fans):
    """U(-limit, limit), ``limit = gain * sqrt(6 / (fan_in + fan_out))``:
    the default of a ``Linear`` weight ``[in, out]``."""

    def __call__(self, t, generator=None):
        fi, fo = self._fans(t.shape)
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return uniform_(t, -limit, limit, generator)


class KaimingNormal(Initializer):
    """N(0, std²), ``std = sqrt(2 / ((1 + negative_slope²) * fan_in))``."""

    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="relu"):
        self.fan_in, self.negative_slope = fan_in, negative_slope

    def _fan_in(self, shape):
        return self.fan_in if self.fan_in is not None else fans(shape)[0]

    def __call__(self, t, generator=None):
        std = math.sqrt(2.0 / ((1 + self.negative_slope ** 2)
                               * self._fan_in(t.shape)))
        return normal_(t, 0.0, std, generator)


class KaimingUniform(KaimingNormal):
    """U(-limit, limit), ``limit = sqrt(6 / ((1 + negative_slope²) *
    fan_in))``; ``fan_in`` from the fan rule (:func:`fans`) unless
    given."""

    def __call__(self, t, generator=None):
        limit = math.sqrt(6.0 / ((1 + self.negative_slope ** 2)
                                 * self._fan_in(t.shape)))
        return uniform_(t, -limit, limit, generator)


class Assign(Initializer):
    """Copies ``value`` (array, list or tensor) of ``t``'s shape."""

    def __init__(self, value):
        self.value = value

    @torch.no_grad()
    def __call__(self, t, generator=None):
        v = self.value
        if not isinstance(v, torch.Tensor):
            from ..core.tensor import numpy_to_torch

            v = numpy_to_torch(np.asarray(v))
        if tuple(v.shape) != tuple(t.shape):
            raise AssertionError(
                f"Assign shape mismatch {tuple(v.shape)} vs {tuple(t.shape)}")
        return t.copy_(v)


class Orthogonal(Initializer):
    """``gain`` times a matrix with orthonormal rows or columns (the
    weight flattened to ``[shape[0], prod(shape[1:])]``): the Q factor of
    a standard normal matrix, its signs fixed by R's diagonal."""

    def __init__(self, gain=1.0):
        self.gain = gain

    @torch.no_grad()
    def __call__(self, t, generator=None):
        if t.device.type == "meta":
            return t
        rows, cols = int(t.shape[0]), math.prod(t.shape[1:])
        z = torch.empty(max(rows, cols), min(rows, cols),
                        dtype=torch.float32, device=t.device)
        z.normal_(0.0, 1.0, generator=_gen(t, generator))
        q, r = torch.linalg.qr(z)
        q = q * torch.sign(torch.diagonal(r))[None, :]
        q = q if rows >= cols else q.t()
        return t.copy_((self.gain * q).reshape(t.shape))


def calculate_gain(nonlinearity, param=None):
    gains = {"sigmoid": 1.0, "tanh": 5.0 / 3, "relu": float(np.sqrt(2.0)),
             "leaky_relu": float(np.sqrt(2.0 / (1 + (param or 0.01) ** 2))),
             "selu": 3.0 / 4, "linear": 1.0, "conv2d": 1.0}
    return gains.get(nonlinearity, 1.0)


_global_weight_init = None
_global_bias_init = None


def set_global_initializer(weight_init, bias_init=None):
    """Records the two initializers, as the reference does (its
    ``create_parameter`` does not read them)."""
    global _global_weight_init, _global_bias_init
    _global_weight_init = weight_init
    _global_bias_init = bias_init

"""Parameter initializers with ``paddle_tpu``'s fan rule and an explicit
``torch.Generator``.  Counterpart of the part of ``paddle_tpu/nn/
initializer.py`` that the MoE and vision layers use: ``XavierUniform``
(``xavier_uniform_``), the zero bias, and ``Constant``, ``Uniform`` and
``KaimingUniform`` as objects that fill a tensor in place.  Uniform
draws are made in fp32 and cast to the tensor's dtype, as the reference
draws them."""
from __future__ import annotations

import math

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
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


@torch.no_grad()
def xavier_uniform_(t, generator, gain=1.0):
    """Fill ``t`` in place from U(-limit, limit), ``limit = gain *
    sqrt(6 / (fan_in + fan_out))``, drawing from ``generator`` (on
    ``t``'s device) in fp32."""
    fi, fo = fans(t.shape)
    limit = gain * math.sqrt(6.0 / (fi + fo))
    return uniform_(t, -limit, limit, generator)


@torch.no_grad()
def uniform_(t, low, high, generator):
    """Fill ``t`` in place from U(low, high), drawn in fp32 from
    ``generator`` (on ``t``'s device)."""
    u = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    u.uniform_(low, high, generator=generator)
    return t.copy_(u)


@torch.no_grad()
def zeros_(t):
    """Fill ``t`` with zeros (the bias default)."""
    return t.zero_()


class Constant:
    """Fills with ``value``."""

    def __init__(self, value=0.0):
        self.value = value

    @torch.no_grad()
    def __call__(self, t, generator=None):
        return t.fill_(self.value)


class Uniform:
    """U(low, high)."""

    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, t, generator):
        return uniform_(t, self.low, self.high, generator)


class KaimingUniform:
    """U(-limit, limit), ``limit = sqrt(6 / ((1 + negative_slope²) *
    fan_in))``; ``fan_in`` from the fan rule (``fans``) unless given."""

    def __init__(self, fan_in=None, negative_slope=0.0):
        self.fan_in, self.negative_slope = fan_in, negative_slope

    def __call__(self, t, generator):
        fi = self.fan_in if self.fan_in is not None else fans(t.shape)[0]
        limit = math.sqrt(6.0 / ((1 + self.negative_slope ** 2) * fi))
        return uniform_(t, -limit, limit, generator)

"""Parameter initializers with ``paddle_tpu``'s fan rule and an explicit
``torch.Generator``.  Counterpart of the part of ``paddle_tpu/nn/
initializer.py`` that the MoE layers use (``XavierUniform`` and the zero
bias)."""
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
    u = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    u.uniform_(-limit, limit, generator=generator)
    return t.copy_(u)


@torch.no_grad()
def zeros_(t):
    """Fill ``t`` with zeros (the bias default)."""
    return t.zero_()

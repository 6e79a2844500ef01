"""``Conv2D``.  Counterpart of ``paddle_tpu/nn/conv.py`` ``Conv2D``: an
OIHW weight ``[out, in / groups, kh, kw]`` drawn Kaiming-uniform with
``fan_in = in * kh * kw / groups``, and a bias drawn from U(-1/sqrt(fan_in),
1/sqrt(fan_in)) unless ``bias_attr=False``; both on ``device`` (default
CUDA, see ``device.resolve_device``) from ``generator`` (default: a
generator on ``device`` seeded with 0).  ``Conv1D`` and
``Conv2DTranspose`` are not ported yet (ROADMAP.md Queue 1, item 4)."""
from __future__ import annotations

import math

import torch
from torch import nn

from ..device import resolve_device
from ..ops.nn_ops import _pair
from . import functional as F
from .initializer import KaimingUniform, Uniform, seeded_generator


class Conv2D(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, bias_attr=None,
                 data_format="NCHW", device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _pair(kernel_size)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        fan_in = in_channels * math.prod(self._kernel_size) // groups
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels // groups, *self._kernel_size,
            device=device, dtype=dtype))
        self.bias = (nn.Parameter(torch.empty(out_channels, device=device,
                                              dtype=dtype))
                     if bias_attr is not False else None)
        generator = generator or seeded_generator(device)
        KaimingUniform(fan_in=fan_in)(self.weight, generator)
        if self.bias is not None:
            bound = 1.0 / math.sqrt(fan_in)
            Uniform(-bound, bound)(self.bias, generator)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, stride=self._stride,
                        padding=self._padding, dilation=self._dilation,
                        groups=self._groups, data_format=self._data_format)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")

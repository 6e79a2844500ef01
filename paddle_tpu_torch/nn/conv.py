"""``Conv2D``, ``Conv1D`` and ``Conv2DTranspose``.  Counterparts of
``paddle_tpu/nn/conv.py``: ``Conv2D`` has an OIHW weight ``[out, in /
groups, kh, kw]`` drawn Kaiming-uniform with ``fan_in = in * kh * kw /
groups``, and a bias drawn from U(-1/sqrt(fan_in), 1/sqrt(fan_in));
``Conv1D`` an OIL weight ``[out, in / groups, k]`` and
``Conv2DTranspose`` an IOHW one ``[in, out / groups, kh, kw]``, both
Kaiming-uniform with that fan_in and a zero bias (the reference gives
them no bias initializer).  No bias with ``bias_attr=False``.  All on
``device`` (default CUDA, see ``device.resolve_device``) from
``generator`` (default: a generator on ``device`` seeded with 0)."""
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
        bound = 1.0 / math.sqrt(fan_in)
        _conv_params(self, (out_channels, in_channels // groups,
                            *self._kernel_size), out_channels, fan_in,
                     bias_attr, device, dtype, generator,
                     bias_init=Uniform(-bound, bound))

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, stride=self._stride,
                        padding=self._padding, dilation=self._dilation,
                        groups=self._groups, data_format=self._data_format)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")


def _conv_params(module, shape, out_channels, fan_in, bias_attr, device,
                 dtype, generator, bias_init=None):
    """The weight (Kaiming-uniform over ``fan_in``) and the bias (zero, or
    ``bias_init``; absent with ``bias_attr=False``) of a conv layer."""
    module.weight = nn.Parameter(torch.empty(*shape, device=device,
                                             dtype=dtype))
    module.bias = (nn.Parameter(torch.zeros(out_channels, device=device,
                                            dtype=dtype))
                   if bias_attr is not False else None)
    generator = generator or seeded_generator(device)
    KaimingUniform(fan_in=fan_in)(module.weight, generator)
    if module.bias is not None and bias_init is not None:
        bias_init(module.bias, generator)


class Conv1D(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 bias_attr=None, data_format="NCL", device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        device = resolve_device(device)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        _conv_params(self, (out_channels, in_channels // groups,
                            int(kernel_size)), out_channels,
                     in_channels * int(kernel_size) // groups, bias_attr,
                     device, dtype, generator)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, stride=self._stride,
                        padding=self._padding, dilation=self._dilation,
                        groups=self._groups)


class Conv2DTranspose(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 bias_attr=None, data_format="NCHW", device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        device = resolve_device(device)
        self._stride = stride
        self._padding = padding
        self._output_padding = output_padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        k = _pair(kernel_size)
        _conv_params(self, (in_channels, out_channels // groups, *k),
                     out_channels, in_channels * math.prod(k) // groups,
                     bias_attr, device, dtype, generator)

    def forward(self, x, output_size=None):
        """``output_size`` is ignored, as the reference ignores it."""
        return F.conv2d_transpose(
            x, self.weight, self.bias, stride=self._stride,
            padding=self._padding, output_padding=self._output_padding,
            dilation=self._dilation, groups=self._groups,
            data_format=self._data_format)

"""``Conv2D``, ``Conv1D`` and ``Conv2DTranspose``.  Counterparts of
``paddle_tpu/nn/conv.py``, with its constructors (``padding_mode``,
``weight_attr``, ``bias_attr``, ``data_format``; ``device``, ``dtype``
and ``generator`` keyword-only): ``Conv2D`` has an OIHW weight ``[out,
in / groups, kh, kw]`` drawn Kaiming-uniform with ``fan_in = in * kh *
kw / groups``, and a bias drawn from U(-1/sqrt(fan_in),
1/sqrt(fan_in)); ``Conv1D`` an OIL weight ``[out, in / groups, k]`` and
``Conv2DTranspose`` an IOHW one ``[in, out / groups, kh, kw]``, both
Kaiming-uniform with that fan_in and a zero bias (the reference gives
them no bias initializer).  No bias with ``bias_attr=False``.  All on
``device`` (default: the current place), the weight drawn before the
bias from ``generator`` (default: the port's generator of that
device)."""
from __future__ import annotations

import math

from ..ops.nn_ops import _pair
from . import functional as F
from .initializer import KaimingUniform, Uniform
from .layers import Layer


def _conv_params(module, shape, out_channels, fan_in, weight_attr,
                 bias_attr, device, dtype, generator, bias_init=None):
    """The weight (Kaiming-uniform over ``fan_in``) and the bias (zero, or
    ``bias_init``; absent with ``bias_attr=False``) of a conv layer."""
    kw = dict(dtype=dtype, device=device, generator=generator)
    module.weight = module.create_parameter(
        list(shape), attr=weight_attr,
        default_initializer=KaimingUniform(fan_in=fan_in), **kw)
    module.bias = module.create_parameter(
        [out_channels], attr=bias_attr, is_bias=True,
        default_initializer=bias_init, **kw)


class Conv2D(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, dtype=None, generator=None):
        super().__init__()
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
                     weight_attr, bias_attr, device, dtype, generator,
                     bias_init=Uniform(-bound, bound))

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, stride=self._stride,
                        padding=self._padding, dilation=self._dilation,
                        groups=self._groups, data_format=self._data_format)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")


class Conv1D(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 device=None, dtype=None, generator=None):
        super().__init__()
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        _conv_params(self, (out_channels, in_channels // groups,
                            int(kernel_size)), out_channels,
                     in_channels * int(kernel_size) // groups, weight_attr,
                     bias_attr, device, dtype, generator)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, stride=self._stride,
                        padding=self._padding, dilation=self._dilation,
                        groups=self._groups)


class Conv2DTranspose(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, dtype=None, generator=None):
        super().__init__()
        self._stride = stride
        self._padding = padding
        self._output_padding = output_padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        k = _pair(kernel_size)
        _conv_params(self, (in_channels, out_channels // groups, *k),
                     out_channels, in_channels * math.prod(k) // groups,
                     weight_attr, bias_attr, device, dtype, generator)

    def forward(self, x, output_size=None):
        """``output_size`` is ignored, as the reference ignores it."""
        return F.conv2d_transpose(
            x, self.weight, self.bias, stride=self._stride,
            padding=self._padding, output_padding=self._output_padding,
            dilation=self._dilation, groups=self._groups,
            data_format=self._data_format)

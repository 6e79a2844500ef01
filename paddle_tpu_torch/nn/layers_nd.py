"""N-d conv and pool layers.  Counterpart of the conv and pool part of
``paddle_tpu/nn/layers_nd.py``: ``Conv3D``, ``Conv1DTranspose``,
``Conv3DTranspose``, ``MaxPool1D`` / ``3D``, ``AvgPool1D`` / ``3D``,
``LPPool1D`` / ``2D``, the adaptive pools, ``MaxUnPool1D`` / ``2D`` /
``3D`` and ``FractionalMaxPool2D`` / ``3D``, thin layers over
``nn.functional``.

The conv layers' weights are the reference's: ``[out, in / groups, *k]``
(``[in, out / groups, *k]`` transposed) drawn Kaiming-uniform with
``fan_in = in * prod(k) / groups``, and a bias from U(-1/sqrt(fan_in),
1/sqrt(fan_in)) unless ``bias_attr=False``, on ``device`` (default
CUDA) from ``generator`` (default: a generator on ``device`` seeded with
0).  The pool layers pass on what the reference's pass on: the max
pools ``return_mask`` (not ``ceil_mode``), the average pools
``exclusive`` (not ``ceil_mode``).  ``FractionalMaxPool2D`` / ``3D``
without ``random_u`` draw it from ``generator`` at every call (default:
a CPU generator seeded with 0).  The rest of the reference's module
(``Maxout``, ``Softmax2D``, the paddings, ``SpectralNorm``, the losses,
beam search) is not ported yet (ROADMAP.md Queue 1, item 9).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..device import resolve_device
from . import functional as F
from .conv import _conv_params
from .initializer import Uniform, seeded_generator


def _ntuple(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


class _ConvNd(nn.Module):
    def __init__(self, nd, transpose, in_channels, out_channels,
                 kernel_size, stride, padding, output_padding, dilation,
                 groups, bias_attr, device, dtype, generator):
        super().__init__()
        device = resolve_device(device)
        k = _ntuple(kernel_size, nd)
        self._stride = stride
        self._padding = padding
        self._output_padding = output_padding
        self._dilation = dilation
        self._groups = groups
        fan_in = in_channels * math.prod(k) // groups
        shape = ((in_channels, out_channels // groups) if transpose
                 else (out_channels, in_channels // groups)) + k
        bound = 1.0 / math.sqrt(fan_in)
        _conv_params(self, shape, out_channels, fan_in, bias_attr, device,
                     dtype, generator, bias_init=Uniform(-bound, bound))


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 bias_attr=None, data_format="NCDHW", device=None,
                 dtype=torch.float32, generator=None):
        super().__init__(3, False, in_channels, out_channels, kernel_size,
                         stride, padding, 0, dilation, groups, bias_attr,
                         device, dtype, generator)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups)


class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 bias_attr=None, data_format="NCL", device=None,
                 dtype=torch.float32, generator=None):
        super().__init__(1, True, in_channels, out_channels, kernel_size,
                         stride, padding, output_padding, dilation, groups,
                         bias_attr, device, dtype, generator)

    def forward(self, x, output_size=None):
        return F.conv1d_transpose(
            x, self.weight, self.bias, self._stride, self._padding,
            self._output_padding, self._groups, self._dilation)


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 bias_attr=None, data_format="NCDHW", device=None,
                 dtype=torch.float32, generator=None):
        super().__init__(3, True, in_channels, out_channels, kernel_size,
                         stride, padding, output_padding, dilation, groups,
                         bias_attr, device, dtype, generator)

    def forward(self, x, output_size=None):
        return F.conv3d_transpose(
            x, self.weight, self.bias, self._stride, self._padding,
            self._output_padding, self._groups, self._dilation)


# -- pooling -----------------------------------------------------------------

def _pool_layer(fn_name, has_exclusive=False):
    class _Pool(nn.Module):
        def __init__(self, kernel_size=None, stride=None, padding=0,
                     ceil_mode=False, exclusive=True, return_mask=False,
                     data_format=None):
            super().__init__()
            self.kernel_size = kernel_size
            self.stride = stride
            self.padding = padding
            self.ceil_mode = ceil_mode
            self.exclusive = exclusive
            self.return_mask = return_mask

        def forward(self, x):
            kw = ({"return_mask": self.return_mask} if "max" in fn_name
                  else {"exclusive": self.exclusive} if has_exclusive
                  else {})
            return getattr(F, fn_name)(x, self.kernel_size, self.stride,
                                       self.padding, **kw)

    _Pool.__name__ = _Pool.__qualname__ = fn_name.title().replace("_", "")
    return _Pool


MaxPool1D = _pool_layer("max_pool1d")
MaxPool3D = _pool_layer("max_pool3d")
AvgPool1D = _pool_layer("avg_pool1d", has_exclusive=True)
AvgPool3D = _pool_layer("avg_pool3d", has_exclusive=True)


class LPPool1D(nn.Module):
    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format="NCL"):
        super().__init__()
        self.norm_type = norm_type
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode

    def forward(self, x):
        return F.lp_pool1d(x, self.norm_type, self.kernel_size, self.stride,
                           self.padding, self.ceil_mode)


class LPPool2D(LPPool1D):
    def forward(self, x):
        return F.lp_pool2d(x, self.norm_type, self.kernel_size, self.stride,
                           self.padding, self.ceil_mode)


def _adaptive_layer(fn_name):
    class _Adaptive(nn.Module):
        def __init__(self, output_size, return_mask=False,
                     data_format=None):
            super().__init__()
            self.output_size = output_size
            self.return_mask = return_mask

        def forward(self, x):
            fn = getattr(F, fn_name)
            if "max" in fn_name:
                return fn(x, self.output_size, return_mask=self.return_mask)
            return fn(x, self.output_size)

    _Adaptive.__name__ = _Adaptive.__qualname__ = \
        fn_name.title().replace("_", "")
    return _Adaptive


AdaptiveAvgPool1D = _adaptive_layer("adaptive_avg_pool1d")
AdaptiveAvgPool3D = _adaptive_layer("adaptive_avg_pool3d")
AdaptiveMaxPool1D = _adaptive_layer("adaptive_max_pool1d")
AdaptiveMaxPool2D = _adaptive_layer("adaptive_max_pool2d")
AdaptiveMaxPool3D = _adaptive_layer("adaptive_max_pool3d")


def _unpool_layer(fn_name):
    class _Unpool(nn.Module):
        def __init__(self, kernel_size, stride=None, padding=0,
                     data_format=None, output_size=None):
            super().__init__()
            self.kernel_size = kernel_size
            self.stride = stride
            self.padding = padding
            self.output_size = output_size

        def forward(self, x, indices):
            return getattr(F, fn_name)(x, indices, self.kernel_size,
                                       self.stride, self.padding,
                                       output_size=self.output_size)

    _Unpool.__name__ = _Unpool.__qualname__ = \
        fn_name.title().replace("_", "")
    return _Unpool


MaxUnPool1D = _unpool_layer("max_unpool1d")
MaxUnPool2D = _unpool_layer("max_unpool2d")
MaxUnPool3D = _unpool_layer("max_unpool3d")


class FractionalMaxPool2D(nn.Module):
    def __init__(self, output_size, kernel_size=None, random_u=None,
                 return_mask=False, generator=None):
        super().__init__()
        self.output_size = output_size
        self.random_u = random_u
        self.generator = generator or seeded_generator("cpu")

    def forward(self, x):
        return F.fractional_max_pool2d(x, self.output_size,
                                       random_u=self.random_u,
                                       generator=self.generator)


class FractionalMaxPool3D(FractionalMaxPool2D):
    def forward(self, x):
        return F.fractional_max_pool3d(x, self.output_size,
                                       random_u=self.random_u,
                                       generator=self.generator)

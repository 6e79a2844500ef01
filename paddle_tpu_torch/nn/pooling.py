"""Pooling layers.  Counterparts of ``paddle_tpu/nn/pooling.py``
``MaxPool2D``, ``AvgPool2D`` and ``AdaptiveAvgPool2D`` (stride defaults
to the kernel size), over ``nn.functional``'s pools.  They take the
reference's arguments and pass on what it passes on: ``MaxPool2D`` its
``ceil_mode`` (which ``max_pool2d`` ignores) and not ``return_mask``;
``AvgPool2D`` neither ``ceil_mode`` nor ``divisor_override``."""
from __future__ import annotations

from . import functional as F
from .layers import Layer


class MaxPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, data_format="NCHW", name=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride if stride is not None else kernel_size
        self.padding = padding
        self.ceil_mode = ceil_mode
        self.data_format = data_format

    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                            ceil_mode=self.ceil_mode,
                            data_format=self.data_format)


class AvgPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride if stride is not None else kernel_size
        self.padding = padding
        self.exclusive = exclusive
        self.data_format = data_format

    def forward(self, x):
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding,
                            exclusive=self.exclusive,
                            data_format=self.data_format)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, self.data_format)

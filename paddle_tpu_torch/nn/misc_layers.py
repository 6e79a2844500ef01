"""The remaining common layers.  Counterpart of
``paddle_tpu/nn/misc_layers.py``: ``Bilinear``, ``GLU``,
``AlphaDropout``, ``RReLU``, ``Dropout3D``, ``Pad1D`` / ``2D`` / ``3D``,
``ZeroPad2D`` and ``Unflatten``.  The random layers draw from the
``generator`` they are given, else from the port's generator of the
input's device."""
from __future__ import annotations

import math

import torch

from ..ops import activation as A
from . import functional as F
from . import initializer as I
from .layers import Layer


class Bilinear(Layer):
    """``out[b, o] = x1[b] · weight[o] · x2[b] + bias[o]``, weight ``[out,
    in1, in2]`` and bias both from U(-1/sqrt(in1), 1/sqrt(in1))."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None, *, device=None,
                 dtype=None, generator=None):
        super().__init__()
        bound = 1.0 / math.sqrt(in1_features)
        kw = dict(device=device, dtype=dtype, generator=generator,
                  default_initializer=I.Uniform(-bound, bound))
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features], attr=weight_attr,
            **kw)
        self.bias = self.create_parameter([out_features], attr=bias_attr,
                                          is_bias=True, **kw)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class GLU(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return A.glu(x, axis=self.axis)


class AlphaDropout(Layer):
    """SELU-consistent dropout (``F.alpha_dropout``)."""

    def __init__(self, p=0.5, name=None, *, generator=None):
        super().__init__()
        if not 0 <= p <= 1:
            raise ValueError("p must be in [0, 1]")
        self.p = p
        self.generator = generator

    def forward(self, x):
        return F.alpha_dropout(x, self.p, self.training,
                               generator=self.generator)


class RReLU(Layer):
    """``F.rrelu``: a random negative slope in [lower, upper] per element
    in training, their mean in eval."""

    def __init__(self, lower=1.0 / 8, upper=1.0 / 3, name=None, *,
                 generator=None):
        super().__init__()
        self.lower, self.upper = lower, upper
        self.generator = generator

    def forward(self, x):
        return F.rrelu(x, self.lower, self.upper, self.training,
                       generator=self.generator)


class Dropout3D(Layer):
    """Channel-wise dropout of ``[N, C, D, H, W]`` (``F.dropout3d``)."""

    def __init__(self, p=0.5, data_format="NCDHW", name=None, *,
                 generator=None):
        super().__init__()
        self.p, self.data_format = p, data_format
        self.generator = generator

    def forward(self, x):
        return F.dropout3d(x, self.p, self.training, self.data_format,
                           generator=self.generator)


class _PadND(Layer):
    """Pads the ``SPATIAL`` trailing axes (``(left, right[, top, bottom[,
    front, back]])``, the innermost axis first) in ``constant``,
    ``reflect``, ``replicate`` or ``circular`` mode."""

    SPATIAL = 2

    def __init__(self, padding, mode="constant", value=0.0, data_format=None,
                 name=None):
        super().__init__()
        n = self.SPATIAL
        if isinstance(padding, int):
            padding = [padding] * (2 * n)
        if len(padding) != 2 * n:
            raise ValueError(f"padding must have {2 * n} values")
        self.padding = [int(p) for p in padding]
        self.mode = mode
        self.value = value
        self.data_format = data_format or ("NCL" if n == 1 else
                                           "NCHW" if n == 2 else "NCDHW")

    def forward(self, x):
        channels_last = not self.data_format.startswith("NC")
        if channels_last:
            x = torch.movedim(x, -1, 1)
        if self.mode == "constant":
            out = torch.nn.functional.pad(x, self.padding, value=self.value)
        else:
            out = torch.nn.functional.pad(x, self.padding, mode=self.mode)
        return torch.movedim(out, 1, -1) if channels_last else out


class Pad1D(_PadND):
    SPATIAL = 1


class Pad2D(_PadND):
    SPATIAL = 2


class Pad3D(_PadND):
    SPATIAL = 3


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, mode="constant", value=0.0,
                         data_format=data_format)


class Unflatten(Layer):
    def __init__(self, axis, shape, name=None):
        super().__init__()
        self.axis = axis
        self.shape = list(shape)

    def forward(self, x):
        axis = self.axis % x.dim()
        return x.reshape(list(x.shape[:axis]) + self.shape
                         + list(x.shape[axis + 1:]))

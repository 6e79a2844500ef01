"""Vision-shaped layers.  Counterpart of ``paddle_tpu/nn/vision_layers.py``:
the pixel and channel shuffles, ``GridSampler``, ``Fold`` / ``Unfold``,
the 2-D upsampling layers and the metric layers, over
``nn.functional``."""
from __future__ import annotations

from . import functional as F
from .layers import Layer


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self._r, self._fmt = upscale_factor, data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self._r, self._fmt)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self._r, self._fmt = downscale_factor, data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self._r, self._fmt)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self._groups, self._fmt = groups, data_format

    def forward(self, x):
        return F.channel_shuffle(x, self._groups, self._fmt)


class GridSampler(Layer):
    def __init__(self, mode="bilinear", padding_mode="zeros",
                 align_corners=True, name=None):
        super().__init__()
        self._kw = dict(mode=mode, padding_mode=padding_mode,
                        align_corners=align_corners)

    def forward(self, x, grid):
        return F.grid_sample(x, grid, **self._kw)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self._args = (output_sizes, kernel_sizes, strides, paddings,
                      dilations)

    def forward(self, x):
        return F.fold(x, *self._args)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self._args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self._args)


class UpsamplingNearest2D(Layer):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._size, self._scale, self._fmt = size, scale_factor, data_format

    def forward(self, x):
        return F.interpolate(x, size=self._size, scale_factor=self._scale,
                             mode="nearest", data_format=self._fmt)


class UpsamplingBilinear2D(UpsamplingNearest2D):
    def forward(self, x):
        return F.interpolate(x, size=self._size, scale_factor=self._scale,
                             mode="bilinear", align_corners=True,
                             data_format=self._fmt)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self._axis, self._eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, axis=self._axis, eps=self._eps)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self._kw = dict(p=p, epsilon=epsilon, keepdim=keepdim)

    def forward(self, x, y):
        return F.pairwise_distance(x, y, **self._kw)

"""MobileNetV1.  Counterpart of ``paddle_tpu/vision/models/mobilenetv1.py``:
depthwise-separable conv stacks, ``scale`` multiplying every channel
count; the same layers, names and forward.  Layers are made by
``_layers.Maker`` on ``device`` (default CUDA) from ``seed``."""
from __future__ import annotations

import torch
from torch import nn

from ... import nn as pnn
from ._layers import Maker


class ConvBNLayer(nn.Module):
    def __init__(self, mk, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, num_groups=1):
        super().__init__()
        self.conv = mk.conv(in_channels, out_channels, kernel_size,
                            stride=stride, padding=padding,
                            groups=num_groups, bias_attr=False)
        self.norm = mk.bn(out_channels)
        self.act = pnn.ReLU()

    def forward(self, x):
        return self.act(self.norm(self.conv(x)))


class DepthwiseSeparable(nn.Module):
    def __init__(self, mk, in_channels, out_channels1, out_channels2,
                 num_groups, stride, scale):
        super().__init__()
        self.depthwise = ConvBNLayer(
            mk, in_channels, int(out_channels1 * scale), 3, stride=stride,
            padding=1, num_groups=int(num_groups * scale))
        self.pointwise = ConvBNLayer(
            mk, int(out_channels1 * scale), int(out_channels2 * scale), 1)

    def forward(self, x):
        return self.pointwise(self.depthwise(x))


class MobileNetV1(nn.Module):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, seed=0):
        super().__init__()
        mk = Maker(device, seed)
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool

        self.conv1 = ConvBNLayer(mk, 3, int(32 * scale), 3, stride=2,
                                 padding=1)
        # (in, ch1, ch2, groups, stride) per the reference's block table
        cfg = [
            (32, 32, 64, 32, 1), (64, 64, 128, 64, 2),
            (128, 128, 128, 128, 1), (128, 128, 256, 128, 2),
            (256, 256, 256, 256, 1), (256, 256, 512, 256, 2),
            (512, 512, 512, 512, 1), (512, 512, 512, 512, 1),
            (512, 512, 512, 512, 1), (512, 512, 512, 512, 1),
            (512, 512, 512, 512, 1), (512, 512, 1024, 512, 2),
            (1024, 1024, 1024, 1024, 1),
        ]
        self.blocks = pnn.Sequential(*[
            DepthwiseSeparable(mk, int(i * scale), c1, c2, g, s, scale)
            for i, c1, c2, g, s in cfg])
        if with_pool:
            self.pool = pnn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = mk.linear(int(1024 * scale), num_classes)

    def forward(self, x):
        x = self.blocks(self.conv1(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV1(scale=scale, **kwargs)

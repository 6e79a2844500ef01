"""MobileNetV2.  Counterpart of ``paddle_tpu/vision/models/mobilenetv2.py``:
inverted residuals with depthwise (grouped) convs, channel counts kept
multiples of 8 by ``_make_divisible``; the same layers, names and
forward.  Layers are made by ``_layers.Maker`` on ``device`` (default
CUDA) from ``seed``."""
from __future__ import annotations

from torch import nn

from ... import nn as pnn
from ._layers import Maker


def _make_divisible(v, divisor=8, min_value=None):
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class ConvBNReLU(pnn.Sequential):
    def __init__(self, mk, in_c, out_c, kernel=3, stride=1, groups=1):
        pad = (kernel - 1) // 2
        super().__init__(
            mk.conv(in_c, out_c, kernel, stride=stride, padding=pad,
                    groups=groups, bias_attr=False),
            mk.bn(out_c),
            pnn.ReLU6())


class InvertedResidual(nn.Module):
    def __init__(self, mk, inp, oup, stride, expand_ratio):
        super().__init__()
        self.stride = stride
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNReLU(mk, inp, hidden, kernel=1))
        layers += [
            ConvBNReLU(mk, hidden, hidden, stride=stride, groups=hidden),
            mk.conv(hidden, oup, 1, bias_attr=False),
            mk.bn(oup),
        ]
        self.conv = pnn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(nn.Module):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, seed=0):
        super().__init__()
        mk = Maker(device, seed)
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [
            # t, c, n, s
            [1, 16, 1, 1], [6, 24, 2, 2], [6, 32, 3, 2], [6, 64, 4, 2],
            [6, 96, 3, 1], [6, 160, 3, 2], [6, 320, 1, 1],
        ]
        in_c = _make_divisible(32 * scale)
        last_c = _make_divisible(1280 * max(1.0, scale))
        features = [ConvBNReLU(mk, 3, in_c, stride=2)]
        for t, c, n, s in cfg:
            out_c = _make_divisible(c * scale)
            for i in range(n):
                features.append(InvertedResidual(
                    mk, in_c, out_c, s if i == 0 else 1, t))
                in_c = out_c
        features.append(ConvBNReLU(mk, in_c, last_c, kernel=1))
        self.features = pnn.Sequential(*features)
        if with_pool:
            self.pool = pnn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = pnn.Sequential(
                mk.dropout(0.2), mk.linear(last_c, num_classes))
        self._last_c = last_c

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = x.reshape(x.shape[0], -1)
            x = self.classifier(x)
        return x


def mobilenet_v2(scale=1.0, **kwargs):
    return MobileNetV2(scale=scale, **kwargs)

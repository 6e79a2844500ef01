"""MobileNetV3 Small / Large.  Counterpart of
``paddle_tpu/vision/models/mobilenetv3.py``: inverted residuals with
optional squeeze-excite, hardswish / relu activations, channel counts
snapped to multiples of 8; the same layers, names and forward.  Layers
are made by ``_layers.Maker`` on ``device`` (default CUDA) from
``seed``."""
from __future__ import annotations

import torch
from torch import nn

from ... import nn as pnn
from ._layers import Maker


def _make_divisible(v, divisor=8, min_value=None):
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class SqueezeExcitation(nn.Module):
    def __init__(self, mk, channels, squeeze_channels):
        super().__init__()
        self.avgpool = pnn.AdaptiveAvgPool2D((1, 1))
        self.fc1 = mk.conv(channels, squeeze_channels, 1)
        self.relu = pnn.ReLU()
        self.fc2 = mk.conv(squeeze_channels, channels, 1)
        self.hard = pnn.Hardsigmoid()

    def forward(self, x):
        s = self.hard(self.fc2(self.relu(self.fc1(self.avgpool(x)))))
        return x * s


class InvertedResidual(nn.Module):
    def __init__(self, mk, in_ch, exp_ch, out_ch, kernel, stride, use_se,
                 act):
        super().__init__()
        self.use_res = stride == 1 and in_ch == out_ch
        act_layer = pnn.Hardswish if act == "hardswish" else pnn.ReLU
        layers = []
        if exp_ch != in_ch:
            layers += [mk.conv(in_ch, exp_ch, 1, bias_attr=False),
                       mk.bn(exp_ch), act_layer()]
        # the reference's block order: dw-conv -> BN -> act -> SE -> pw-conv
        layers += [mk.conv(exp_ch, exp_ch, kernel, stride=stride,
                           padding=kernel // 2, groups=exp_ch,
                           bias_attr=False),
                   mk.bn(exp_ch), act_layer()]
        if use_se:
            layers.append(SqueezeExcitation(
                mk, exp_ch, _make_divisible(exp_ch // 4)))
        layers += [mk.conv(exp_ch, out_ch, 1, bias_attr=False),
                   mk.bn(out_ch)]
        self.block = pnn.Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        return x + out if self.use_res else out


# (kernel, exp, out, use_se, act, stride)
_LARGE = [
    (3, 16, 16, False, "relu", 1), (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1), (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1), (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hardswish", 2),
    (3, 200, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1),
    (3, 480, 112, True, "hardswish", 1),
    (3, 672, 112, True, "hardswish", 1),
    (5, 672, 160, True, "hardswish", 2),
    (5, 960, 160, True, "hardswish", 1),
    (5, 960, 160, True, "hardswish", 1),
]
_SMALL = [
    (3, 16, 16, True, "relu", 2), (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1), (5, 96, 40, True, "hardswish", 2),
    (5, 240, 40, True, "hardswish", 1),
    (5, 240, 40, True, "hardswish", 1),
    (5, 120, 48, True, "hardswish", 1),
    (5, 144, 48, True, "hardswish", 1),
    (5, 288, 96, True, "hardswish", 2),
    (5, 576, 96, True, "hardswish", 1),
    (5, 576, 96, True, "hardswish", 1),
]


class MobileNetV3(nn.Module):
    def __init__(self, config, last_channel, scale=1.0, num_classes=1000,
                 with_pool=True, device=None, seed=0):
        super().__init__()
        mk = Maker(device, seed)
        self.num_classes = num_classes
        self.with_pool = with_pool
        in_ch = _make_divisible(16 * scale)
        self.conv = pnn.Sequential(
            mk.conv(3, in_ch, 3, stride=2, padding=1, bias_attr=False),
            mk.bn(in_ch), pnn.Hardswish())
        blocks = []
        for k, exp, out, se, act, s in config:
            exp_ch = _make_divisible(exp * scale)
            out_ch = _make_divisible(out * scale)
            blocks.append(InvertedResidual(mk, in_ch, exp_ch, out_ch, k, s,
                                           se, act))
            in_ch = out_ch
        self.blocks = pnn.Sequential(*blocks)
        # in_ch is already scale-adjusted; 6x expansion only
        last_conv = _make_divisible(6 * in_ch)
        self.lastconv = pnn.Sequential(
            mk.conv(in_ch, last_conv, 1, bias_attr=False),
            mk.bn(last_conv), pnn.Hardswish())
        if with_pool:
            self.pool = pnn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.classifier = pnn.Sequential(
                mk.linear(last_conv, last_channel), pnn.Hardswish(),
                mk.dropout(0.2), mk.linear(last_channel, num_classes))

    def forward(self, x):
        x = self.lastconv(self.blocks(self.conv(x)))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(torch.flatten(x, 1))
        return x


class MobileNetV3Large(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, seed=0):
        super().__init__(_LARGE, 1280, scale, num_classes, with_pool,
                         device, seed)


class MobileNetV3Small(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, seed=0):
        super().__init__(_SMALL, 1024, scale, num_classes, with_pool,
                         device, seed)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV3Large(scale=scale, **kwargs)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV3Small(scale=scale, **kwargs)

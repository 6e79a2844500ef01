"""ShuffleNetV2.  Counterpart of ``paddle_tpu/vision/models/
shufflenetv2.py``: channel split, branch, concat and channel shuffle (a
reshape, a transpose, a reshape); the same layers, names and forward.
Layers are made by ``_layers.Maker`` on ``device`` (default CUDA) from
``seed``."""
from __future__ import annotations

import torch
from torch import nn

from ... import nn as pnn
from ._layers import Maker


def channel_shuffle(x, groups):
    n, c, h, w = x.shape
    x = x.reshape(n, groups, c // groups, h, w)
    x = x.permute(0, 2, 1, 3, 4)
    return x.reshape(n, c, h, w)


def _act_layer(act):
    return pnn.Swish() if act == "swish" else pnn.ReLU()


def _conv_bn_act(mk, in_ch, out_ch, kernel, stride=1, groups=1, act="relu"):
    layers = [mk.conv(in_ch, out_ch, kernel, stride=stride,
                      padding=kernel // 2, groups=groups, bias_attr=False),
              mk.bn(out_ch)]
    if act is not None:
        layers.append(_act_layer(act))
    return pnn.Sequential(*layers)


class InvertedResidual(nn.Module):
    """Stride-1 unit: split channels, transform one branch, shuffle."""

    def __init__(self, mk, channels, act="relu"):
        super().__init__()
        half = channels // 2
        self.branch = pnn.Sequential(
            _conv_bn_act(mk, half, half, 1, act=act),
            _conv_bn_act(mk, half, half, 3, groups=half, act=None),
            _conv_bn_act(mk, half, half, 1, act=act))

    def forward(self, x):
        half = x.shape[1] // 2
        x1 = x[:, :half]
        x2 = x[:, half:]
        out = torch.cat([x1, self.branch(x2)], 1)
        return channel_shuffle(out, 2)


class InvertedResidualDS(nn.Module):
    """Stride-2 (downsampling) unit: both branches transform."""

    def __init__(self, mk, in_ch, out_ch, act="relu"):
        super().__init__()
        half = out_ch // 2
        self.branch1 = pnn.Sequential(
            _conv_bn_act(mk, in_ch, in_ch, 3, stride=2, groups=in_ch,
                         act=None),
            _conv_bn_act(mk, in_ch, half, 1, act=act))
        self.branch2 = pnn.Sequential(
            _conv_bn_act(mk, in_ch, half, 1, act=act),
            _conv_bn_act(mk, half, half, 3, stride=2, groups=half, act=None),
            _conv_bn_act(mk, half, half, 1, act=act))

    def forward(self, x):
        out = torch.cat([self.branch1(x), self.branch2(x)], 1)
        return channel_shuffle(out, 2)


_STAGE_OUT = {
    0.25: [24, 24, 48, 96, 512], 0.33: [24, 32, 64, 128, 512],
    0.5: [24, 48, 96, 192, 1024], 1.0: [24, 116, 232, 464, 1024],
    1.5: [24, 176, 352, 704, 1024], 2.0: [24, 244, 488, 976, 2048],
}


class ShuffleNetV2(nn.Module):
    def __init__(self, scale=1.0, act="relu", num_classes=1000,
                 with_pool=True, device=None, seed=0):
        super().__init__()
        mk = Maker(device, seed)
        self.num_classes = num_classes
        self.with_pool = with_pool
        stage_out = _STAGE_OUT[scale]
        stage_repeats = [4, 8, 4]

        self.conv1 = _conv_bn_act(mk, 3, stage_out[0], 3, stride=2,
                                  act=act)
        self.maxpool = pnn.MaxPool2D(3, stride=2, padding=1)
        blocks = []
        in_ch = stage_out[0]
        for stage, repeats in enumerate(stage_repeats):
            out_ch = stage_out[stage + 1]
            blocks.append(InvertedResidualDS(mk, in_ch, out_ch, act=act))
            for _ in range(repeats - 1):
                blocks.append(InvertedResidual(mk, out_ch, act=act))
            in_ch = out_ch
        self.blocks = pnn.Sequential(*blocks)
        self.conv_last = _conv_bn_act(mk, in_ch, stage_out[-1], 1, act=act)
        if with_pool:
            self.pool = pnn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = mk.linear(stage_out[-1], num_classes)

    def forward(self, x):
        x = self.conv_last(self.blocks(self.maxpool(self.conv1(x))))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x


def shufflenet_v2_x0_25(pretrained=False, **kwargs):
    return ShuffleNetV2(scale=0.25, **kwargs)


def shufflenet_v2_x0_33(pretrained=False, **kwargs):
    return ShuffleNetV2(scale=0.33, **kwargs)


def shufflenet_v2_x0_5(pretrained=False, **kwargs):
    return ShuffleNetV2(scale=0.5, **kwargs)


def shufflenet_v2_x1_0(pretrained=False, **kwargs):
    return ShuffleNetV2(scale=1.0, **kwargs)


def shufflenet_v2_x1_5(pretrained=False, **kwargs):
    return ShuffleNetV2(scale=1.5, **kwargs)


def shufflenet_v2_x2_0(pretrained=False, **kwargs):
    return ShuffleNetV2(scale=2.0, **kwargs)


def shufflenet_v2_swish(pretrained=False, **kwargs):
    return ShuffleNetV2(scale=1.0, act="swish", **kwargs)

"""Inception v3.  Counterpart of ``paddle_tpu/vision/models/
inceptionv3.py``: the A / B / C / D / E blocks over 299 x 299 inputs; the
same layers, names and forward.  Layers are made by ``_layers.Maker`` on
``device`` (default CUDA) from ``seed``."""
from __future__ import annotations

import torch
from torch import nn

from ... import nn as pnn
from ._layers import Maker


class ConvBNLayer(nn.Module):
    def __init__(self, mk, in_ch, out_ch, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = mk.conv(in_ch, out_ch, kernel, stride=stride,
                            padding=padding, bias_attr=False)
        self.bn = mk.bn(out_ch)
        self.relu = pnn.ReLU()

    def forward(self, x):
        return self.relu(self.bn(self.conv(x)))


class InceptionA(nn.Module):
    def __init__(self, mk, in_ch, pool_features):
        super().__init__()
        self.b1 = ConvBNLayer(mk, in_ch, 64, 1)
        self.b5 = pnn.Sequential(ConvBNLayer(mk, in_ch, 48, 1),
                                 ConvBNLayer(mk, 48, 64, 5, padding=2))
        self.b3 = pnn.Sequential(ConvBNLayer(mk, in_ch, 64, 1),
                                 ConvBNLayer(mk, 64, 96, 3, padding=1),
                                 ConvBNLayer(mk, 96, 96, 3, padding=1))
        self.pool = pnn.AvgPool2D(3, stride=1, padding=1)
        self.bp = ConvBNLayer(mk, in_ch, pool_features, 1)

    def forward(self, x):
        return torch.cat([self.b1(x), self.b5(x), self.b3(x),
                          self.bp(self.pool(x))], 1)


class InceptionB(nn.Module):
    """Grid reduction 35 -> 17."""

    def __init__(self, mk, in_ch):
        super().__init__()
        self.b3 = ConvBNLayer(mk, in_ch, 384, 3, stride=2)
        self.b3d = pnn.Sequential(ConvBNLayer(mk, in_ch, 64, 1),
                                  ConvBNLayer(mk, 64, 96, 3, padding=1),
                                  ConvBNLayer(mk, 96, 96, 3, stride=2))
        self.pool = pnn.MaxPool2D(3, stride=2)

    def forward(self, x):
        return torch.cat([self.b3(x), self.b3d(x), self.pool(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, mk, in_ch, ch7):
        super().__init__()
        self.b1 = ConvBNLayer(mk, in_ch, 192, 1)
        self.b7 = pnn.Sequential(
            ConvBNLayer(mk, in_ch, ch7, 1),
            ConvBNLayer(mk, ch7, ch7, (1, 7), padding=(0, 3)),
            ConvBNLayer(mk, ch7, 192, (7, 1), padding=(3, 0)))
        self.b7d = pnn.Sequential(
            ConvBNLayer(mk, in_ch, ch7, 1),
            ConvBNLayer(mk, ch7, ch7, (7, 1), padding=(3, 0)),
            ConvBNLayer(mk, ch7, ch7, (1, 7), padding=(0, 3)),
            ConvBNLayer(mk, ch7, ch7, (7, 1), padding=(3, 0)),
            ConvBNLayer(mk, ch7, 192, (1, 7), padding=(0, 3)))
        self.pool = pnn.AvgPool2D(3, stride=1, padding=1)
        self.bp = ConvBNLayer(mk, in_ch, 192, 1)

    def forward(self, x):
        return torch.cat([self.b1(x), self.b7(x), self.b7d(x),
                          self.bp(self.pool(x))], 1)


class InceptionD(nn.Module):
    """Grid reduction 17 -> 8."""

    def __init__(self, mk, in_ch):
        super().__init__()
        self.b3 = pnn.Sequential(ConvBNLayer(mk, in_ch, 192, 1),
                                 ConvBNLayer(mk, 192, 320, 3, stride=2))
        self.b7 = pnn.Sequential(
            ConvBNLayer(mk, in_ch, 192, 1),
            ConvBNLayer(mk, 192, 192, (1, 7), padding=(0, 3)),
            ConvBNLayer(mk, 192, 192, (7, 1), padding=(3, 0)),
            ConvBNLayer(mk, 192, 192, 3, stride=2))
        self.pool = pnn.MaxPool2D(3, stride=2)

    def forward(self, x):
        return torch.cat([self.b3(x), self.b7(x), self.pool(x)], 1)


class InceptionE(nn.Module):
    def __init__(self, mk, in_ch):
        super().__init__()
        self.b1 = ConvBNLayer(mk, in_ch, 320, 1)
        self.b3_stem = ConvBNLayer(mk, in_ch, 384, 1)
        self.b3_a = ConvBNLayer(mk, 384, 384, (1, 3), padding=(0, 1))
        self.b3_b = ConvBNLayer(mk, 384, 384, (3, 1), padding=(1, 0))
        self.b3d_stem = pnn.Sequential(
            ConvBNLayer(mk, in_ch, 448, 1),
            ConvBNLayer(mk, 448, 384, 3, padding=1))
        self.b3d_a = ConvBNLayer(mk, 384, 384, (1, 3), padding=(0, 1))
        self.b3d_b = ConvBNLayer(mk, 384, 384, (3, 1), padding=(1, 0))
        self.pool = pnn.AvgPool2D(3, stride=1, padding=1)
        self.bp = ConvBNLayer(mk, in_ch, 192, 1)

    def forward(self, x):
        s = self.b3_stem(x)
        d = self.b3d_stem(x)
        return torch.cat(
            [self.b1(x), self.b3_a(s), self.b3_b(s), self.b3d_a(d),
             self.b3d_b(d), self.bp(self.pool(x))], 1)


class InceptionV3(nn.Module):
    def __init__(self, num_classes=1000, with_pool=True, device=None,
                 seed=0):
        super().__init__()
        mk = Maker(device, seed)
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = pnn.Sequential(
            ConvBNLayer(mk, 3, 32, 3, stride=2),
            ConvBNLayer(mk, 32, 32, 3),
            ConvBNLayer(mk, 32, 64, 3, padding=1),
            pnn.MaxPool2D(3, stride=2),
            ConvBNLayer(mk, 64, 80, 1),
            ConvBNLayer(mk, 80, 192, 3),
            pnn.MaxPool2D(3, stride=2))
        self.blocks = pnn.Sequential(
            InceptionA(mk, 192, 32), InceptionA(mk, 256, 64),
            InceptionA(mk, 288, 64),
            InceptionB(mk, 288),
            InceptionC(mk, 768, 128), InceptionC(mk, 768, 160),
            InceptionC(mk, 768, 160), InceptionC(mk, 768, 192),
            InceptionD(mk, 768),
            InceptionE(mk, 1280), InceptionE(mk, 2048))
        if with_pool:
            self.pool = pnn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.drop = mk.dropout(0.2)
            self.fc = mk.linear(2048, num_classes)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(self.drop(torch.flatten(x, 1)))
        return x


def inception_v3(pretrained=False, **kwargs):
    return InceptionV3(**kwargs)

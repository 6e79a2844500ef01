"""SqueezeNet 1.0 / 1.1.  Counterpart of
``paddle_tpu/vision/models/squeezenet.py``: Fire modules; the same
layers, names and forward.  Layers are made by ``_layers.Maker`` on
``device`` (default CUDA) from ``seed``."""
from __future__ import annotations

import torch
from torch import nn

from ... import nn as pnn
from ._layers import Maker


class Fire(nn.Module):
    def __init__(self, mk, in_ch, squeeze_ch, e1_ch, e3_ch):
        super().__init__()
        self.squeeze = mk.conv(in_ch, squeeze_ch, 1)
        self.expand1 = mk.conv(squeeze_ch, e1_ch, 1)
        self.expand3 = mk.conv(squeeze_ch, e3_ch, 3, padding=1)
        self.relu = pnn.ReLU()

    def forward(self, x):
        s = self.relu(self.squeeze(x))
        return torch.cat([self.relu(self.expand1(s)),
                          self.relu(self.expand3(s))], 1)


class SqueezeNet(nn.Module):
    def __init__(self, version="1.0", num_classes=1000, with_pool=True,
                 device=None, seed=0):
        super().__init__()
        mk = Maker(device, seed)
        self.num_classes = num_classes
        self.with_pool = with_pool
        if version == "1.0":
            self.features = pnn.Sequential(
                mk.conv(3, 96, 7, stride=2), pnn.ReLU(),
                pnn.MaxPool2D(3, stride=2),
                Fire(mk, 96, 16, 64, 64), Fire(mk, 128, 16, 64, 64),
                Fire(mk, 128, 32, 128, 128), pnn.MaxPool2D(3, stride=2),
                Fire(mk, 256, 32, 128, 128), Fire(mk, 256, 48, 192, 192),
                Fire(mk, 384, 48, 192, 192), Fire(mk, 384, 64, 256, 256),
                pnn.MaxPool2D(3, stride=2), Fire(mk, 512, 64, 256, 256))
        elif version == "1.1":
            self.features = pnn.Sequential(
                mk.conv(3, 64, 3, stride=2), pnn.ReLU(),
                pnn.MaxPool2D(3, stride=2),
                Fire(mk, 64, 16, 64, 64), Fire(mk, 128, 16, 64, 64),
                pnn.MaxPool2D(3, stride=2),
                Fire(mk, 128, 32, 128, 128), Fire(mk, 256, 32, 128, 128),
                pnn.MaxPool2D(3, stride=2),
                Fire(mk, 256, 48, 192, 192), Fire(mk, 384, 48, 192, 192),
                Fire(mk, 384, 64, 256, 256), Fire(mk, 512, 64, 256, 256))
        else:
            raise ValueError(f"unsupported version {version!r}")
        if num_classes > 0:
            self.classifier = pnn.Sequential(
                mk.dropout(0.5), mk.conv(512, num_classes, 1), pnn.ReLU())
        if with_pool:
            self.pool = pnn.AdaptiveAvgPool2D((1, 1))

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = self.classifier(x)
        if self.with_pool:
            x = self.pool(x)
        return torch.flatten(x, 1)


def squeezenet1_0(pretrained=False, **kwargs):
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    return SqueezeNet("1.1", **kwargs)

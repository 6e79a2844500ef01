"""GoogLeNet (Inception v1).  Counterpart of ``paddle_tpu/vision/models/
googlenet.py``: returns (main, aux1, aux2) logits in training mode, the
main logits in eval; the same layers, names and forward.  Layers are
made by ``_layers.Maker`` on ``device`` (default CUDA) from ``seed``."""
from __future__ import annotations

import torch
from torch import nn

from ... import nn as pnn
from ._layers import Maker


class Inception(nn.Module):
    def __init__(self, mk, in_ch, c1, c3r, c3, c5r, c5, proj):
        super().__init__()
        relu = pnn.ReLU
        self.branch1 = pnn.Sequential(mk.conv(in_ch, c1, 1), relu())
        self.branch2 = pnn.Sequential(
            mk.conv(in_ch, c3r, 1), relu(),
            mk.conv(c3r, c3, 3, padding=1), relu())
        self.branch3 = pnn.Sequential(
            mk.conv(in_ch, c5r, 1), relu(),
            mk.conv(c5r, c5, 5, padding=2), relu())
        self.branch4 = pnn.Sequential(
            pnn.MaxPool2D(3, stride=1, padding=1),
            mk.conv(in_ch, proj, 1), relu())

    def forward(self, x):
        return torch.cat([self.branch1(x), self.branch2(x),
                          self.branch3(x), self.branch4(x)], 1)


class _AuxHead(nn.Module):
    def __init__(self, mk, in_ch, num_classes):
        super().__init__()
        self.pool = pnn.AdaptiveAvgPool2D((4, 4))
        self.conv = mk.conv(in_ch, 128, 1)
        self.relu = pnn.ReLU()
        self.fc1 = mk.linear(128 * 16, 1024)
        self.drop = mk.dropout(0.7)
        self.fc2 = mk.linear(1024, num_classes)

    def forward(self, x):
        x = self.relu(self.conv(self.pool(x)))
        x = self.relu(self.fc1(torch.flatten(x, 1)))
        return self.fc2(self.drop(x))


class GoogLeNet(nn.Module):
    def __init__(self, num_classes=1000, with_pool=True, device=None,
                 seed=0):
        super().__init__()
        mk = Maker(device, seed)
        self.num_classes = num_classes
        self.with_pool = with_pool
        relu = pnn.ReLU
        self.stem = pnn.Sequential(
            mk.conv(3, 64, 7, stride=2, padding=3), relu(),
            pnn.MaxPool2D(3, stride=2, padding=1),
            mk.conv(64, 64, 1), relu(),
            mk.conv(64, 192, 3, padding=1), relu(),
            pnn.MaxPool2D(3, stride=2, padding=1))
        self.inc3a = Inception(mk, 192, 64, 96, 128, 16, 32, 32)
        self.inc3b = Inception(mk, 256, 128, 128, 192, 32, 96, 64)
        self.pool3 = pnn.MaxPool2D(3, stride=2, padding=1)
        self.inc4a = Inception(mk, 480, 192, 96, 208, 16, 48, 64)
        self.inc4b = Inception(mk, 512, 160, 112, 224, 24, 64, 64)
        self.inc4c = Inception(mk, 512, 128, 128, 256, 24, 64, 64)
        self.inc4d = Inception(mk, 512, 112, 144, 288, 32, 64, 64)
        self.inc4e = Inception(mk, 528, 256, 160, 320, 32, 128, 128)
        self.pool4 = pnn.MaxPool2D(3, stride=2, padding=1)
        self.inc5a = Inception(mk, 832, 256, 160, 320, 32, 128, 128)
        self.inc5b = Inception(mk, 832, 384, 192, 384, 48, 128, 128)
        if with_pool:
            self.pool5 = pnn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.drop = mk.dropout(0.4)
            self.fc = mk.linear(1024, num_classes)
            self.aux1 = _AuxHead(mk, 512, num_classes)
            self.aux2 = _AuxHead(mk, 528, num_classes)

    def forward(self, x):
        x = self.stem(x)
        x = self.pool3(self.inc3b(self.inc3a(x)))
        x = self.inc4a(x)
        aux1 = self.aux1(x) if (self.num_classes > 0 and self.training) \
            else None
        x = self.inc4d(self.inc4c(self.inc4b(x)))
        aux2 = self.aux2(x) if (self.num_classes > 0 and self.training) \
            else None
        x = self.pool4(self.inc4e(x))
        x = self.inc5b(self.inc5a(x))
        if self.with_pool:
            x = self.pool5(x)
        if self.num_classes > 0:
            x = self.fc(self.drop(torch.flatten(x, 1)))
        if self.training and self.num_classes > 0:
            return x, aux1, aux2
        return x


def googlenet(pretrained=False, **kwargs):
    return GoogLeNet(**kwargs)

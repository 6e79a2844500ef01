"""LeNet and AlexNet.  Counterpart of ``paddle_tpu/vision/models/
simple.py``; the same layers, names and forward.  Layers are made by
``_layers.Maker`` on ``device`` (default CUDA) from ``seed``."""
from __future__ import annotations

from torch import nn

from ... import nn as pnn
from ._layers import Maker


class LeNet(nn.Module):
    """MNIST-scale convnet (1 x 28 x 28 inputs)."""

    def __init__(self, num_classes=10, device=None, seed=0):
        super().__init__()
        mk = Maker(device, seed)
        self.num_classes = num_classes
        self.features = pnn.Sequential(
            mk.conv(1, 6, 3, stride=1, padding=1), pnn.ReLU(),
            pnn.MaxPool2D(2, 2),
            mk.conv(6, 16, 5, stride=1, padding=0), pnn.ReLU(),
            pnn.MaxPool2D(2, 2))
        if num_classes > 0:
            self.fc = pnn.Sequential(
                mk.linear(400, 120), mk.linear(120, 84),
                mk.linear(84, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = x.reshape(x.shape[0], -1)
            x = self.fc(x)
        return x


class AlexNet(nn.Module):
    """224 x 224 inputs."""

    def __init__(self, num_classes=1000, device=None, seed=0):
        super().__init__()
        mk = Maker(device, seed)
        self.num_classes = num_classes
        self.features = pnn.Sequential(
            mk.conv(3, 64, 11, stride=4, padding=2), pnn.ReLU(),
            pnn.MaxPool2D(3, 2),
            mk.conv(64, 192, 5, padding=2), pnn.ReLU(),
            pnn.MaxPool2D(3, 2),
            mk.conv(192, 384, 3, padding=1), pnn.ReLU(),
            mk.conv(384, 256, 3, padding=1), pnn.ReLU(),
            mk.conv(256, 256, 3, padding=1), pnn.ReLU(),
            pnn.MaxPool2D(3, 2))
        self.avgpool = pnn.AdaptiveAvgPool2D((6, 6))
        if num_classes > 0:
            self.classifier = pnn.Sequential(
                mk.dropout(), mk.linear(256 * 6 * 6, 4096), pnn.ReLU(),
                mk.dropout(), mk.linear(4096, 4096), pnn.ReLU(),
                mk.linear(4096, num_classes))

    def forward(self, x):
        x = self.avgpool(self.features(x))
        if self.num_classes > 0:
            x = x.reshape(x.shape[0], -1)
            x = self.classifier(x)
        return x


def alexnet(**kwargs):
    return AlexNet(**kwargs)

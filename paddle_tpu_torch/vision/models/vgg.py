"""The VGG family.  Counterpart of ``paddle_tpu/vision/models/vgg.py``:
``make_layers`` over the A / B / D / E configs, with optional batch
norm; the same layers, names and forward.  Layers are made by
``_layers.Maker`` on ``device`` (default CUDA) from ``seed``."""
from __future__ import annotations

from torch import nn

from ... import nn as pnn
from ._layers import Maker

_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512,
          512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
          512, 512, "M", 512, 512, 512, 512, "M"],
}


def make_layers(cfg, batch_norm=False, mk=None):
    mk = mk or Maker()
    layers = []
    in_c = 3
    for v in cfg:
        if v == "M":
            layers.append(pnn.MaxPool2D(kernel_size=2, stride=2))
        else:
            layers.append(mk.conv(in_c, v, 3, padding=1))
            if batch_norm:
                layers.append(mk.bn(v))
            layers.append(pnn.ReLU())
            in_c = v
    return pnn.Sequential(*layers)


class VGG(nn.Module):
    """``VGG(features, num_classes, with_pool)``; ``mk`` makes the
    classifier (default: a ``Maker`` on CUDA from seed 0)."""

    def __init__(self, features, num_classes=1000, with_pool=True, mk=None):
        super().__init__()
        mk = mk or Maker()
        self.features = features
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = pnn.AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = pnn.Sequential(
                mk.linear(512 * 7 * 7, 4096), pnn.ReLU(), mk.dropout(),
                mk.linear(4096, 4096), pnn.ReLU(), mk.dropout(),
                mk.linear(4096, num_classes))
        self.num_classes = num_classes

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = x.reshape(x.shape[0], -1)
            x = self.classifier(x)
        return x


def _vgg(cfg, batch_norm, device=None, seed=0, **kwargs):
    mk = Maker(device, seed)
    return VGG(make_layers(_CFGS[cfg], batch_norm, mk), mk=mk, **kwargs)


def vgg11(batch_norm=False, **kwargs):
    return _vgg("A", batch_norm, **kwargs)


def vgg13(batch_norm=False, **kwargs):
    return _vgg("B", batch_norm, **kwargs)


def vgg16(batch_norm=False, **kwargs):
    return _vgg("D", batch_norm, **kwargs)


def vgg19(batch_norm=False, **kwargs):
    return _vgg("E", batch_norm, **kwargs)

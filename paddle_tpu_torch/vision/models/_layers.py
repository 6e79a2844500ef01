"""The zoo's layer factory: every layer of one model made on one device
and drawn from one ``torch.Generator`` in construction order (convs
Kaiming-uniform with their biases, ``Linear`` weights Xavier-uniform and
biases 0, batch norms 1 and 0), and the dropouts drawing their masks
from the same generator, as ``resnet.py`` builds the ResNets."""
from __future__ import annotations

from ... import nn as pnn
from ...device import resolve_device
from ...nn.initializer import seeded_generator


class Maker:
    def __init__(self, device=None, seed=0):
        self.device = resolve_device(device)
        self.gen = seeded_generator(self.device, seed)

    def conv(self, in_ch, out_ch, kernel, stride=1, padding=0, groups=1,
             bias_attr=None):
        return pnn.Conv2D(in_ch, out_ch, kernel, stride=stride,
                          padding=padding, groups=groups,
                          bias_attr=bias_attr, device=self.device,
                          generator=self.gen)

    def bn(self, ch):
        return pnn.BatchNorm2D(ch, device=self.device)

    def linear(self, in_f, out_f):
        return pnn.Linear(in_f, out_f, device=self.device,
                          generator=self.gen)

    def dropout(self, p=0.5):
        return pnn.Dropout(p, generator=self.gen)

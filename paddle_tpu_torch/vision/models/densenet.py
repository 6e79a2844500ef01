"""DenseNet.  Counterpart of ``paddle_tpu/vision/models/densenet.py``:
dense blocks concatenating every earlier layer's features, halving
transitions between blocks; the same layers, names and forward.  Layers
are made by ``_layers.Maker`` on ``device`` (default CUDA) from
``seed``."""
from __future__ import annotations

import torch
from torch import nn

from ... import nn as pnn
from ._layers import Maker


class DenseLayer(nn.Module):
    def __init__(self, mk, in_ch, growth_rate, bn_size):
        super().__init__()
        self.norm1 = mk.bn(in_ch)
        self.conv1 = mk.conv(in_ch, bn_size * growth_rate, 1,
                             bias_attr=False)
        self.norm2 = mk.bn(bn_size * growth_rate)
        self.conv2 = mk.conv(bn_size * growth_rate, growth_rate, 3,
                             padding=1, bias_attr=False)
        self.relu = pnn.ReLU()

    def forward(self, x):
        out = self.conv1(self.relu(self.norm1(x)))
        out = self.conv2(self.relu(self.norm2(out)))
        return torch.cat([x, out], 1)


class DenseBlock(nn.Module):
    def __init__(self, mk, num_layers, in_ch, growth_rate, bn_size):
        super().__init__()
        self.layers = pnn.LayerList([
            DenseLayer(mk, in_ch + i * growth_rate, growth_rate, bn_size)
            for i in range(num_layers)])

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class Transition(nn.Module):
    def __init__(self, mk, in_ch, out_ch):
        super().__init__()
        self.norm = mk.bn(in_ch)
        self.conv = mk.conv(in_ch, out_ch, 1, bias_attr=False)
        self.relu = pnn.ReLU()
        self.pool = pnn.AvgPool2D(2, stride=2)

    def forward(self, x):
        return self.pool(self.conv(self.relu(self.norm(x))))


_CFG = {
    121: (32, [6, 12, 24, 16]), 161: (48, [6, 12, 36, 24]),
    169: (32, [6, 12, 32, 32]), 201: (32, [6, 12, 48, 32]),
    264: (32, [6, 12, 64, 48]),
}


class DenseNet(nn.Module):
    def __init__(self, layers=121, bn_size=4, dropout=0.0,
                 num_classes=1000, with_pool=True, device=None, seed=0):
        super().__init__()
        mk = Maker(device, seed)
        self.num_classes = num_classes
        self.with_pool = with_pool
        growth_rate, block_cfg = _CFG[layers]
        num_init = 2 * growth_rate

        self.conv1 = mk.conv(3, num_init, 7, stride=2, padding=3,
                             bias_attr=False)
        self.norm1 = mk.bn(num_init)
        self.relu = pnn.ReLU()
        self.maxpool = pnn.MaxPool2D(3, stride=2, padding=1)

        blocks = []
        ch = num_init
        for i, num_layers in enumerate(block_cfg):
            blocks.append(DenseBlock(mk, num_layers, ch, growth_rate,
                                     bn_size))
            ch += num_layers * growth_rate
            if i != len(block_cfg) - 1:
                blocks.append(Transition(mk, ch, ch // 2))
                ch //= 2
        self.blocks = pnn.Sequential(*blocks)
        self.norm_final = mk.bn(ch)
        if with_pool:
            self.pool = pnn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = mk.linear(ch, num_classes)

    def forward(self, x):
        x = self.maxpool(self.relu(self.norm1(self.conv1(x))))
        x = self.relu(self.norm_final(self.blocks(x)))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x


def densenet121(pretrained=False, **kwargs):
    return DenseNet(121, **kwargs)


def densenet161(pretrained=False, **kwargs):
    return DenseNet(161, **kwargs)


def densenet169(pretrained=False, **kwargs):
    return DenseNet(169, **kwargs)


def densenet201(pretrained=False, **kwargs):
    return DenseNet(201, **kwargs)


def densenet264(pretrained=False, **kwargs):
    return DenseNet(264, **kwargs)

"""The ResNet family.  Counterpart of ``paddle_tpu/vision/models/
resnet.py`` (BASELINE config 1's model, and config 4's backbone):
``BasicBlock`` / ``BottleneckBlock`` over conv + batch norm, the same
ops in the same order (``flatten(x, 1)`` before ``fc``) and the same
parameter and buffer names, so ``models.convert.load_numpy_state``
loads a ``paddle_tpu`` state dict as it is.

Every layer is made on ``device`` (default CUDA, see
``device.resolve_device``) and drawn from one ``torch.Generator`` seeded
with ``seed``, in construction order: convs Kaiming-uniform, ``fc``'s
weight ``[in, out]`` Xavier-uniform and its bias 0, batch norms 1 and 0.

The conv weights are stored channels-last, so cuDNN computes
channels-last (a convolution with a channels-last weight gives a
channels-last output, which the batch norms, ReLUs and adds keep); the
reference computes NHWC inside on the TPU for the same reason.  Shapes
stay NCHW.  On the H100 this is the faster layout (PERF.md §5: the
ResNet-50 step 4–6% faster than NCHW); ``model.to(memory_format=
torch.contiguous_format)`` gives the NCHW one.
"""
from __future__ import annotations

import torch
from torch import nn

from ... import nn as pnn
from ...device import resolve_device
from ...nn.initializer import seeded_generator, xavier_uniform_, zeros_


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None,
                 device=None, generator=None):
        super().__init__()
        norm_layer = norm_layer or pnn.BatchNorm2D
        self.conv1 = pnn.Conv2D(inplanes, planes, 3, stride=stride,
                                padding=1, bias_attr=False, device=device,
                                generator=generator)
        self.bn1 = norm_layer(planes, device=device)
        self.relu = pnn.ReLU()
        self.conv2 = pnn.Conv2D(planes, planes, 3, padding=1,
                                bias_attr=False, device=device,
                                generator=generator)
        self.bn2 = norm_layer(planes, device=device)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None,
                 device=None, generator=None):
        super().__init__()
        norm_layer = norm_layer or pnn.BatchNorm2D
        width = int(planes * (base_width / 64.0)) * groups
        conv = dict(bias_attr=False, device=device, generator=generator)
        self.conv1 = pnn.Conv2D(inplanes, width, 1, **conv)
        self.bn1 = norm_layer(width, device=device)
        self.conv2 = pnn.Conv2D(width, width, 3, padding=1, stride=stride,
                                groups=groups, dilation=dilation, **conv)
        self.bn2 = norm_layer(width, device=device)
        self.conv3 = pnn.Conv2D(width, planes * self.expansion, 1, **conv)
        self.bn3 = norm_layer(planes * self.expansion, device=device)
        self.relu = pnn.ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Module):
    """``ResNet(block, depth, width, num_classes, with_pool, groups)`` as
    in ``paddle_tpu``: depth 18 / 34 / 50 / 101 / 152; ``num_classes=0``
    drops ``fc`` and ``with_pool=False`` the final pool, so the model
    returns the ``[B, 512 * expansion, H/32, W/32]`` features."""

    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, device=None, seed=0):
        super().__init__()
        layer_cfg = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                     101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
        layers = layer_cfg[depth]
        device = resolve_device(device)
        gen = seeded_generator(device, seed)
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.inplanes = 64
        self.dilation = 1

        self.conv1 = pnn.Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                                bias_attr=False, device=device,
                                generator=gen)
        self.bn1 = pnn.BatchNorm2D(self.inplanes, device=device)
        self.relu = pnn.ReLU()
        self.maxpool = pnn.MaxPool2D(3, stride=2, padding=1)
        make = dict(device=device, generator=gen)
        self.layer1 = self._make_layer(block, 64, layers[0], **make)
        self.layer2 = self._make_layer(block, 128, layers[1], 2, **make)
        self.layer3 = self._make_layer(block, 256, layers[2], 2, **make)
        self.layer4 = self._make_layer(block, 512, layers[3], 2, **make)
        if with_pool:
            self.avgpool = pnn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = pnn.Linear(512 * block.expansion, num_classes,
                                 device=device, bias=True)
            xavier_uniform_(self.fc.weight, gen)
            zeros_(self.fc.bias)
        self.to(memory_format=torch.channels_last)

    def _make_layer(self, block, planes, blocks, stride=1, device=None,
                    generator=None):
        dev, gen = device, generator
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = pnn.Sequential(
                pnn.Conv2D(self.inplanes, planes * block.expansion, 1,
                           stride=stride, bias_attr=False, device=dev,
                           generator=gen),
                pnn.BatchNorm2D(planes * block.expansion, device=dev))
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, device=dev,
                        generator=gen)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width, device=dev,
                                generator=gen))
        return pnn.Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = torch.flatten(x, 1)
            x = self.fc(x)
        return x


def _resnet(block, depth, pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError("pretrained weights are not shipped; "
                                  "load a state dict with "
                                  "models.convert.load_numpy_state")
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, width=4, groups=32,
                   **kwargs)


def resnext50_64x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, width=4, groups=64,
                   **kwargs)


def resnext101_32x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, width=4, groups=32,
                   **kwargs)


def resnext101_64x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, width=4, groups=64,
                   **kwargs)


def resnext152_32x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, width=4, groups=32,
                   **kwargs)


def resnext152_64x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, width=4, groups=64,
                   **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, width=128, **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, width=128, **kwargs)

"""ResNet (counterpart of ``paddle_tpu/models/resnet.py``; BASELINE
config 2, ResNet-50 on ImageNet): ``ResNet`` over ``BasicBlock`` or
``BottleneckBlock`` and ``resnet18`` ... ``resnet152``, built on the
port's ``nn`` layers with the reference's names, so the JAX model's
parameters and buffers carry across by name (``params_from_jax``).

``data_format="NHWC"`` runs the whole trunk channels-last: an NCHW input
(last axis not 3) is transposed once at the stem into an NHWC tensor,
and every convolution, batch norm and pool after it keeps that layout
in memory. Train with ``jit.make_train_step(..., optimizer="momentum")``.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import nn

__all__ = ["ResNet", "resnet18", "resnet34", "resnet50", "resnet101",
           "resnet152", "BasicBlock", "BottleneckBlock", "params_from_jax"]


def _conv_bn(in_c, out_c, k, stride=1, groups=1, act=True,
             data_format="NCHW"):
    pad = (k - 1) // 2
    layers = [nn.Conv2D(in_c, out_c, k, stride=stride, padding=pad,
                        groups=groups, bias_attr=False,
                        data_format=data_format),
              nn.BatchNorm2D(out_c, data_format=data_format)]
    if act:
        layers.append(nn.ReLU())
    return nn.Sequential(*layers)


class BasicBlock(nn.Layer):
    expansion = 1

    def __init__(self, in_c, c, stride=1, downsample=None,
                 data_format="NCHW"):
        super().__init__()
        self.conv1 = _conv_bn(in_c, c, 3, stride, data_format=data_format)
        self.conv2 = _conv_bn(c, c, 3, act=False, data_format=data_format)
        self.downsample = downsample
        self.relu = nn.ReLU()

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.conv2(self.conv1(x))
        return self.relu(out + identity)


class BottleneckBlock(nn.Layer):
    expansion = 4

    def __init__(self, in_c, c, stride=1, downsample=None,
                 data_format="NCHW"):
        super().__init__()
        self.conv1 = _conv_bn(in_c, c, 1, data_format=data_format)
        self.conv2 = _conv_bn(c, c, 3, stride, data_format=data_format)
        self.conv3 = _conv_bn(c, c * 4, 1, act=False,
                              data_format=data_format)
        self.downsample = downsample
        self.relu = nn.ReLU()

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.conv3(self.conv2(self.conv1(x)))
        return self.relu(out + identity)


class ResNet(nn.Layer):
    """depth in {18, 34, 50, 101, 152}; ``with_pool`` / ``num_classes``
    follow the reference constructor (``num_classes=0``: the backbone,
    its last feature map)."""

    _SPECS = {18: (BasicBlock, [2, 2, 2, 2]),
              34: (BasicBlock, [3, 4, 6, 3]),
              50: (BottleneckBlock, [3, 4, 6, 3]),
              101: (BottleneckBlock, [3, 4, 23, 3]),
              152: (BottleneckBlock, [3, 8, 36, 3])}

    def __init__(self, block=None, depth=50, num_classes=1000,
                 with_pool=True, data_format="NCHW"):
        super().__init__()
        default, counts = self._SPECS[depth]
        block = block or default
        self.num_classes = num_classes
        self.with_pool = with_pool
        self._data_format = df = data_format
        self.stem = nn.Sequential(
            nn.Conv2D(3, 64, 7, stride=2, padding=3, bias_attr=False,
                      data_format=df),
            nn.BatchNorm2D(64, data_format=df), nn.ReLU(),
            nn.MaxPool2D(kernel_size=3, stride=2, padding=1,
                         data_format=df))
        stages = []
        in_c = 64
        for i, (c, n) in enumerate(zip([64, 128, 256, 512], counts)):
            blocks = []
            for j in range(n):
                stride = 2 if i > 0 and j == 0 else 1
                down = None
                if stride != 1 or in_c != c * block.expansion:
                    down = _conv_bn(in_c, c * block.expansion, 1, stride,
                                    act=False, data_format=df)
                blocks.append(block(in_c, c, stride, down, data_format=df))
                in_c = c * block.expansion
            stages.append(nn.Sequential(*blocks))
        self.layer1, self.layer2, self.layer3, self.layer4 = stages
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1), data_format=df)
        if num_classes > 0:
            self.fc = nn.Linear(512 * block.expansion, num_classes)
        self.flatten = nn.Flatten()

    def forward(self, x):
        if self._data_format == "NHWC" and x.shape[-1] != 3:
            # an NCHW input, transposed once into NHWC memory
            x = x.permute(0, 2, 3, 1).contiguous()
        x = self.stem(x)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(self.flatten(x))
        return x


def resnet18(pretrained=False, **kwargs):
    return ResNet(depth=18, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return ResNet(depth=34, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return ResNet(depth=50, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return ResNet(depth=101, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return ResNet(depth=152, **kwargs)


def params_from_jax(named: dict, buffers: dict | None = None,
                    device="cpu") -> dict:
    """A ``state_dict`` for a vision model of the port (ResNet, VGG,
    MobileNet, LeNet) from the JAX model's parameters and buffers, each
    ``{name: array}`` as ``{n: p.numpy() for n, p in
    model.named_parameters()}`` (and ``named_buffers()``) give them.
    Names and layouts (OIHW filters, (in, out) Linear weights, ``_mean``
    / ``_variance`` running statistics) are the same in both packages, so
    nothing is transposed. Load with ``model.load_state_dict(sd)``."""
    dev = torch.device(device)
    return {k: torch.tensor(np.asarray(v, np.float32), device=dev)
            for k, v in {**named, **(buffers or {})}.items()}

"""VGG (counterpart of ``paddle_tpu/models/vgg.py``): ``VGG`` and
``vgg11`` ... ``vgg19``, with or without batch norm, on the port's
``nn`` layers under the reference's names."""
from __future__ import annotations

from .. import nn
from .resnet import params_from_jax

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19", "params_from_jax"]

_CFGS = {
    11: [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    13: [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
         512, 512, "M"],
    16: [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
         "M", 512, 512, 512, "M"],
    19: [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


class VGG(nn.Layer):
    def __init__(self, depth=16, num_classes=1000, batch_norm=False,
                 dropout=0.5):
        super().__init__()
        layers = []
        in_c = 3
        for v in _CFGS[depth]:
            if v == "M":
                layers.append(nn.MaxPool2D(kernel_size=2, stride=2))
            else:
                layers.append(nn.Conv2D(in_c, v, 3, padding=1))
                if batch_norm:
                    layers.append(nn.BatchNorm2D(v))
                layers.append(nn.ReLU())
                in_c = v
        self.features = nn.Sequential(*layers)
        self.avgpool = nn.AdaptiveAvgPool2D((7, 7))
        self.classifier = nn.Sequential(
            nn.Flatten(),
            nn.Linear(512 * 7 * 7, 4096), nn.ReLU(), nn.Dropout(dropout),
            nn.Linear(4096, 4096), nn.ReLU(), nn.Dropout(dropout),
            nn.Linear(4096, num_classes))

    def forward(self, x):
        return self.classifier(self.avgpool(self.features(x)))


def vgg11(pretrained=False, batch_norm=False, **kw):
    return VGG(11, batch_norm=batch_norm, **kw)


def vgg13(pretrained=False, batch_norm=False, **kw):
    return VGG(13, batch_norm=batch_norm, **kw)


def vgg16(pretrained=False, batch_norm=False, **kw):
    return VGG(16, batch_norm=batch_norm, **kw)


def vgg19(pretrained=False, batch_norm=False, **kw):
    return VGG(19, batch_norm=batch_norm, **kw)

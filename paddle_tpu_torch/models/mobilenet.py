"""MobileNet v1 and v2 (counterpart of ``paddle_tpu/models/mobilenet.py``)
on the port's ``nn`` layers under the reference's names; the depthwise
convolutions are ``Conv2D(groups=C)``."""
from __future__ import annotations

from .. import nn
from .resnet import params_from_jax

__all__ = ["MobileNetV1", "MobileNetV2", "mobilenet_v1", "mobilenet_v2",
           "params_from_jax"]


def _cbr(in_c, out_c, k, stride=1, groups=1, act="relu6"):
    layers = [nn.Conv2D(in_c, out_c, k, stride=stride, padding=(k - 1) // 2,
                        groups=groups, bias_attr=False),
              nn.BatchNorm2D(out_c)]
    if act:
        layers.append(nn.ReLU6() if act == "relu6" else nn.ReLU())
    return nn.Sequential(*layers)


class MobileNetV1(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000):
        super().__init__()
        def c(ch):
            return max(8, int(ch * scale))

        cfg = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
               *[(512, 1)] * 5, (1024, 2), (1024, 1)]
        layers = [_cbr(3, c(32), 3, 2, act="relu")]
        in_c = c(32)
        for out, s in cfg:
            layers.append(_cbr(in_c, in_c, 3, s, groups=in_c, act="relu"))
            layers.append(_cbr(in_c, c(out), 1, act="relu"))
            in_c = c(out)
        self.features = nn.Sequential(*layers)
        self.pool = nn.AdaptiveAvgPool2D((1, 1))
        self.flatten = nn.Flatten()
        self.fc = nn.Linear(in_c, num_classes)

    def forward(self, x):
        return self.fc(self.flatten(self.pool(self.features(x))))


class _InvertedResidual(nn.Layer):
    def __init__(self, in_c, out_c, stride, expand):
        super().__init__()
        hid = in_c * expand
        self.use_res = stride == 1 and in_c == out_c
        layers = []
        if expand != 1:
            layers.append(_cbr(in_c, hid, 1))
        layers += [_cbr(hid, hid, 3, stride, groups=hid),
                   _cbr(hid, out_c, 1, act=None)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000):
        super().__init__()
        def c(ch):
            return max(8, int(ch * scale))

        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        layers = [_cbr(3, c(32), 3, 2)]
        in_c = c(32)
        for t, ch, n, s in cfg:
            for i in range(n):
                layers.append(_InvertedResidual(
                    in_c, c(ch), s if i == 0 else 1, t))
                in_c = c(ch)
        last = max(1280, int(1280 * scale))
        layers.append(_cbr(in_c, last, 1))
        self.features = nn.Sequential(*layers)
        self.pool = nn.AdaptiveAvgPool2D((1, 1))
        self.flatten = nn.Flatten()
        self.classifier = nn.Sequential(nn.Dropout(0.2),
                                        nn.Linear(last, num_classes))

    def forward(self, x):
        return self.classifier(self.flatten(self.pool(self.features(x))))


def mobilenet_v1(pretrained=False, scale=1.0, **kw):
    return MobileNetV1(scale=scale, **kw)


def mobilenet_v2(pretrained=False, scale=1.0, **kw):
    return MobileNetV2(scale=scale, **kw)

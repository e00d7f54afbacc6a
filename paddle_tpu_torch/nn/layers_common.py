"""Common layers (counterpart of ``paddle_tpu/nn/layers_common.py``, as
far as the BERT step and the vision models reach): ``Linear``,
``Embedding``, ``LayerNorm``, ``Dropout``, ``LayerList``, ``Identity``,
``Conv2D``, the pools, the batch norms, ``Flatten``, ``ReLU``,
``ReLU6``, ``Sequential`` and ``CrossEntropyLoss``.

A Layer is a ``torch.nn.Module``. Parameters keep Paddle's layout and
names: a Linear's ``weight`` is (in_features, out_features), a
Conv2D's filter is OIHW whatever the data format, a batch norm keeps its
running statistics as buffers ``_mean`` and ``_variance``, and a
Sequential names its children "0", "1", ... So a parameter or buffer of
the JAX package carries across by name with no transpose.
``weight_attr`` / ``bias_attr`` take an initialiser of
``nn.initializer`` (the reference wraps it in a ParamAttr) or None for
the default; ``bias_attr=False`` leaves the bias out.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from . import functional as F
from .initializer import Constant, Normal, XavierUniform

__all__ = ["Layer", "Linear", "Embedding", "LayerNorm", "Dropout",
           "LayerList", "Identity", "Conv2D", "MaxPool2D", "AvgPool2D",
           "AdaptiveAvgPool2D", "AdaptiveMaxPool2D", "BatchNorm",
           "BatchNorm1D", "BatchNorm2D", "Flatten", "ReLU", "ReLU6",
           "Sequential", "CrossEntropyLoss"]

Layer = nn.Module
LayerList = nn.ModuleList


def _parameter(shape, init):
    p = nn.Parameter(torch.empty(*shape, dtype=torch.float32))
    init(p)
    return p


class Linear(Layer):
    """y = x W + b with W (in_features, out_features)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self.weight = _parameter([in_features, out_features],
                                 weight_attr or XavierUniform())
        if bias_attr is False:
            self.register_parameter("bias", None)
        else:
            self.bias = _parameter([out_features], bias_attr or Constant(0.0))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        ns = [normalized_shape] if isinstance(normalized_shape, int) \
            else list(normalized_shape)
        self._normalized_shape = ns
        self._epsilon = epsilon
        n = math.prod(ns)
        if weight_attr is False:
            self.register_parameter("weight", None)
        else:
            self.weight = _parameter([n], weight_attr or Constant(1.0))
        if bias_attr is False:
            self.register_parameter("bias", None)
        else:
            self.bias = _parameter([n], bias_attr or Constant(0.0))

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        self._padding_idx = padding_idx
        self.weight = _parameter([num_embeddings, embedding_dim],
                                 weight_attr or Normal(0.0, 1.0))

    def forward(self, x):
        return F.embedding(x, self.weight, self._padding_idx)


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p, self.mode = p, mode

    def forward(self, x):
        return F.dropout(x, self.p, training=self.training, mode=self.mode)


class Identity(Layer):
    def forward(self, x):
        return x


class Conv2D(Layer):
    """2-D convolution; the filter is (out, in / groups, kh, kw) and, by
    default, drawn from Normal(0, sqrt(2 / (kh kw in_channels)))."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__()
        k = F._pair(kernel_size)
        self._stride, self._padding = stride, padding
        self._dilation, self._groups = dilation, groups
        self._data_format = data_format
        std = math.sqrt(2.0 / (k[0] * k[1] * in_channels))
        self.weight = _parameter([out_channels, in_channels // groups] + k,
                                 weight_attr or Normal(0.0, std))
        if bias_attr is False:
            self.register_parameter("bias", None)
        else:
            self.bias = _parameter([out_channels], bias_attr or Constant(0.0))

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class MaxPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, data_format="NCHW", name=None):
        super().__init__()
        self._k, self._s, self._p = kernel_size, stride, padding
        self._df = data_format

    def forward(self, x):
        return F.max_pool2d(x, self._k, self._s, self._p,
                            data_format=self._df)


class AvgPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._k, self._s, self._p = kernel_size, stride, padding
        self._excl, self._df = exclusive, data_format

    def forward(self, x):
        return F.avg_pool2d(x, self._k, self._s, self._p,
                            exclusive=self._excl, data_format=self._df)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self._os, self._df = output_size, data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self._os, data_format=self._df)


class AdaptiveMaxPool2D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self._os = output_size

    def forward(self, x):
        return F.adaptive_max_pool2d(x, self._os)


class _BatchNormBase(Layer):
    """Batch norm over the channel axis: ``weight`` (ones) and ``bias``
    (zeros) trainable, running statistics in the float32 buffers
    ``_mean`` (zeros) and ``_variance`` (ones), updated in place while
    training with momentum 0.9 = the share of the old value kept."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self._momentum, self._epsilon = momentum, epsilon
        self._data_format = "NCHW" if data_format in ("NCHW", "NCL",
                                                      "NCDHW") else "NHWC"
        self.weight = _parameter([num_features],
                                 weight_attr or Constant(1.0))
        self.bias = _parameter([num_features], bias_attr or Constant(0.0))
        self.register_buffer("_mean", torch.zeros(num_features))
        self.register_buffer("_variance", torch.ones(num_features))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format)


class BatchNorm(_BatchNormBase):
    """The 1.x BatchNorm layer: num_channels first, an optional
    activation after it."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 param_attr=None, bias_attr=None, dtype="float32",
                 data_layout="NCHW", **kwargs):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout)
        self._act = act

    def forward(self, x):
        y = super().forward(x)
        if self._act:
            y = getattr(F, self._act)(y)
        return y


BatchNorm1D = _BatchNormBase
BatchNorm2D = _BatchNormBase


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self._start, self._stop = start_axis, stop_axis

    def forward(self, x):
        return F.flatten(x, self._start, self._stop)


class ReLU(Layer):
    def forward(self, x):
        return F.relu(x)


class ReLU6(Layer):
    def forward(self, x):
        return F.relu6(x)


class Sequential(nn.Sequential):
    """Children named "0", "1", ... in order, or by the names of
    (name, layer) pairs given one by one or as one list."""

    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) \
                and layers[0] and isinstance(layers[0][0], (list, tuple)):
            layers = tuple(layers[0])
        super().__init__()
        for i, l in enumerate(layers):
            if isinstance(l, tuple):
                self.add_module(l[0], l[1])
            else:
                self.add_module(str(i), l)


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True, name=None):
        super().__init__()
        self._cfg = dict(weight=weight, ignore_index=ignore_index,
                         reduction=reduction, soft_label=soft_label,
                         axis=axis, use_softmax=use_softmax)

    def forward(self, input, label):
        return F.cross_entropy(input, label, **self._cfg)

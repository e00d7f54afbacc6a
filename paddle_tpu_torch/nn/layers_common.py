"""Common layers (counterpart of ``paddle_tpu/nn/layers_common.py``, as
far as the BERT step reaches): ``Linear``, ``Embedding``, ``LayerNorm``,
``Dropout``, ``LayerList``.

A Layer is a ``torch.nn.Module``. Parameters keep Paddle's layout and
names: a Linear's ``weight`` is (in_features, out_features), so a
parameter of the JAX package carries across by name with no transpose.
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
           "LayerList"]

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

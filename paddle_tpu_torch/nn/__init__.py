"""Layers of the port (counterpart of ``paddle_tpu/nn``): a Layer is a
``torch.nn.Module``, a parameter a ``torch.nn.Parameter`` in Paddle's
layout and under Paddle's names."""
from . import functional, initializer
from .layers_common import (AdaptiveAvgPool2D, AdaptiveMaxPool2D, AvgPool2D,
                            BatchNorm, BatchNorm1D, BatchNorm2D, Conv2D,
                            CrossEntropyLoss, Dropout, Embedding, Flatten,
                            Identity, Layer, LayerList, LayerNorm, Linear,
                            MaxPool2D, ReLU, ReLU6, Sequential)
from .transformer import (MultiHeadAttention, TransformerDecoder,
                          TransformerDecoderLayer, TransformerEncoder,
                          TransformerEncoderLayer, Transformer)

__all__ = ["functional", "initializer", "Layer", "Linear", "Embedding",
           "LayerNorm", "Dropout", "LayerList", "Identity", "Conv2D",
           "MaxPool2D", "AvgPool2D", "AdaptiveAvgPool2D",
           "AdaptiveMaxPool2D", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "Flatten", "ReLU", "ReLU6", "Sequential", "CrossEntropyLoss",
           "MultiHeadAttention",
           "TransformerEncoderLayer", "TransformerEncoder",
           "TransformerDecoderLayer", "TransformerDecoder", "Transformer"]

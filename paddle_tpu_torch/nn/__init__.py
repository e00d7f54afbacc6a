"""Layers of the port (counterpart of ``paddle_tpu/nn``): a Layer is a
``torch.nn.Module``, a parameter a ``torch.nn.Parameter`` in Paddle's
layout and under Paddle's names."""
from . import functional, initializer
from .layers_common import (Dropout, Embedding, Layer, LayerList, LayerNorm,
                            Linear)
from .transformer import (MultiHeadAttention, TransformerDecoder,
                          TransformerDecoderLayer, TransformerEncoder,
                          TransformerEncoderLayer, Transformer)

__all__ = ["functional", "initializer", "Layer", "Linear", "Embedding",
           "LayerNorm", "Dropout", "LayerList", "MultiHeadAttention",
           "TransformerEncoderLayer", "TransformerEncoder",
           "TransformerDecoderLayer", "TransformerDecoder", "Transformer"]

"""Transformer encoder stack (counterpart of
``paddle_tpu/nn/transformer.py``): ``MultiHeadAttention``,
``TransformerEncoderLayer``, ``TransformerEncoder``.

Attention goes through ``F.scaled_dot_product_attention`` on
(B, H, S, D): the flash kernels where their domain admits the call, the
composed chain otherwise. Each sub-layer of the encoder layer keeps the
reference's three routes:

  attention   post-LN with a biased out-projection: ``F.fused_out_ln``
              (projection GEMM + dropout + residual + LN in one kernel);
              post-LN otherwise: the projection, then ``_epilogue``
              (``F.fused_dropout_add_ln``); pre-LN: composed residual add.
  FFN         gelu/relu, no activation dropout, biased linears:
              ``F.fused_ffn_block`` (norm "pre" or "post"); otherwise the
              composed ``_ffn`` followed by ``_epilogue`` (post-LN) or a
              residual add (pre-LN).

The KV-cache arguments (incremental decoding) and the decoder classes
come with slice 4 of the port and raise NotImplementedError until then.
"""
from __future__ import annotations

import torch

from . import functional as F
from .layers_common import Dropout, Layer, LayerList, LayerNorm, Linear

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]


def _no_cache(cache, what):
    if cache is not None:
        raise NotImplementedError(
            f"{what}: the KV cache (incremental decoding) comes with slice "
            f"4 of the port")


def _convert_attention_mask(attn_mask, dtype=torch.float32):
    """bool mask (True = keep) -> additive float mask, like the
    reference."""
    if attn_mask is None:
        return None
    if attn_mask.dtype == torch.bool:
        zeros = torch.zeros(attn_mask.shape, dtype=dtype,
                            device=attn_mask.device)
        return torch.where(attn_mask, zeros, torch.full_like(zeros, -1e9))
    return attn_mask


class MultiHeadAttention(Layer):
    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        assert self.head_dim * num_heads == embed_dim
        self.dropout = dropout
        if need_weights:
            raise NotImplementedError(
                "need_weights=True (returning attention probabilities) is "
                "incompatible with the fused attention kernel; use the "
                "composed sdpa_reference in "
                "paddle_tpu_torch.ops.flash_attention")
        self.need_weights = need_weights
        kdim = kdim or embed_dim
        vdim = vdim or embed_dim
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.k_proj = Linear(kdim, embed_dim, weight_attr, bias_attr)
        self.v_proj = Linear(vdim, embed_dim, weight_attr, bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)

    def _split_heads(self, x):
        b, s = x.shape[0], x.shape[1]
        return x.reshape(b, s, self.num_heads, self.head_dim) \
            .permute(0, 2, 1, 3)

    def _merge_heads(self, x):
        b, s = x.shape[0], x.shape[2]
        return x.permute(0, 2, 1, 3).reshape(b, s, self.embed_dim)

    def gen_cache(self, key, value=None, type=None):
        _no_cache(True, "MultiHeadAttention.gen_cache")

    def attention_preproj(self, query, key=None, value=None, attn_mask=None,
                          cache=None):
        """Attention WITHOUT the output projection, shaped (B, S, D): the
        encoder layer folds out_proj's GEMM into its epilogue-fused
        kernel, so the projection stays outside the attention op."""
        _no_cache(cache, "MultiHeadAttention")
        key = query if key is None else key
        value = key if value is None else value
        q = self._split_heads(self.q_proj(query))
        k = self._split_heads(self.k_proj(key))
        v = self._split_heads(self.v_proj(value))
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=_convert_attention_mask(attn_mask),
            dropout_p=self.dropout, training=self.training)
        return self._merge_heads(out)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        return self.out_proj(self.attention_preproj(query, key, value,
                                                    attn_mask, cache))


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        self._config = dict(d_model=d_model, nhead=nhead,
                            dim_feedforward=dim_feedforward, dropout=dropout,
                            activation=activation, attn_dropout=attn_dropout,
                            act_dropout=act_dropout,
                            normalize_before=normalize_before,
                            weight_attr=weight_attr, bias_attr=bias_attr)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout0 = Dropout(dropout)
        self.dropout1 = Dropout(act_dropout)
        self.dropout2 = Dropout(dropout)
        if not hasattr(F, activation):
            raise NotImplementedError(
                f"activation {activation!r} comes with slice 4 of the port "
                f"(the op library); gelu, relu and tanh are ported")
        self.activation = getattr(F, activation)

    def _block_ffn(self) -> bool:
        """Whether the FFN sub-layer takes the one-kernel block."""
        act_drop = self.dropout1.p if self.training else 0.0
        return self._config["activation"] in ("gelu", "relu") \
            and act_drop == 0.0 and self.linear1.bias is not None \
            and self.linear2.bias is not None

    def _ffn(self, src):
        """linear1 -> activation -> (act_dropout) -> linear2, composed."""
        return self.linear2(self.dropout1(self.activation(
            self.linear1(src))))

    def _epilogue(self, src, residual, norm, drop):
        """dropout(src) + residual, then LN: one kernel each way."""
        return F.fused_dropout_add_ln(
            src, residual, norm.weight, norm.bias, dropout_p=drop.p,
            epsilon=norm._epsilon, training=self.training)

    def _attn_sublayer(self, src, src_mask):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        attn = self.self_attn
        if not self.normalize_before and attn.out_proj.bias is not None:
            pre = attn.attention_preproj(src, src, src, src_mask)
            return F.fused_out_ln(
                pre, attn.out_proj.weight, attn.out_proj.bias, residual,
                self.norm1.weight, self.norm1.bias,
                dropout_p=self.dropout0.p, epsilon=self.norm1._epsilon,
                training=self.training)
        src = attn(src, src, src, src_mask)
        if not self.normalize_before:
            return self._epilogue(src, residual, self.norm1, self.dropout0)
        return residual + self.dropout0(src)

    def _ffn_sublayer(self, src):
        residual = src
        if self._block_ffn():
            return F.fused_ffn_block(
                src, self.linear1.weight, self.linear1.bias,
                self.linear2.weight, self.linear2.bias, residual,
                self.norm2.weight, self.norm2.bias,
                activation=self._config["activation"],
                norm="pre" if self.normalize_before else "post",
                dropout_p=self.dropout2.p, epsilon=self.norm2._epsilon,
                training=self.training)
        if self.normalize_before:
            src = self.norm2(src)
        src = self._ffn(src)
        if not self.normalize_before:
            return self._epilogue(src, residual, self.norm2, self.dropout2)
        return residual + self.dropout2(src)

    def forward(self, src, src_mask=None, cache=None):
        _no_cache(cache, "TransformerEncoderLayer")
        return self._ffn_sublayer(self._attn_sublayer(src, src_mask))

    def gen_cache(self, src):
        _no_cache(True, "TransformerEncoderLayer.gen_cache")


def _clone_layer(layer):
    """A new layer of the same configuration with its own, freshly
    initialised parameters."""
    return type(layer)(**layer._config)


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [encoder_layer] +
            [_clone_layer(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        _no_cache(cache, "TransformerEncoder")
        output = src
        for layer in self.layers:
            output = layer(output, src_mask)
        if self.norm is not None:
            output = self.norm(output)
        return output

    def gen_cache(self, src):
        _no_cache(True, "TransformerEncoder.gen_cache")


class _Slice4(Layer):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__} comes with slice 4 of the port (the "
            f"decoder stack and its KV caches); the encoder stack is ported")


class TransformerDecoderLayer(_Slice4):
    pass


class TransformerDecoder(_Slice4):
    pass


class Transformer(_Slice4):
    pass

"""BERT encoder and its pretraining heads in PyTorch (counterpart of
``paddle_tpu/models/bert.py``), built on ``paddle_tpu_torch.nn``.

Module and parameter names mirror the JAX package's, and a Linear weight
stays (in, out), so ``params_from_jax`` carries the reference's
parameters across by name. The MLM decoder is tied to the word
embedding: one ``Parameter`` under two names, whose gradient is the sum
of both uses and which a train step updates once.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import nn
from ..distributed.collective import batch_total
from ..nn import functional as F

__all__ = ["BertConfig", "BertEmbeddings", "BertPooler", "BertModel",
           "BertPretrainingHeads", "BertForPretraining", "params_from_jax"]


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12

    @classmethod
    def base(cls, **kw):
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("vocab_size", 1024)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("num_hidden_layers", 2)
        kw.setdefault("num_attention_heads", 4)
        kw.setdefault("intermediate_size", 128)
        kw.setdefault("max_position_embeddings", 128)
        return cls(**kw)


class BertEmbeddings(nn.Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()

        def attr():
            return nn.initializer.Normal(0.0, cfg.initializer_range)

        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                            weight_attr=attr())
        self.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size, weight_attr=attr())
        self.token_type_embeddings = nn.Embedding(
            cfg.type_vocab_size, cfg.hidden_size, weight_attr=attr())
        self.layer_norm = nn.LayerNorm(cfg.hidden_size,
                                       epsilon=cfg.layer_norm_eps)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        seq_len = input_ids.shape[1]
        if position_ids is None:
            position_ids = torch.arange(seq_len, device=input_ids.device) \
                .unsqueeze(0).expand(input_ids.shape[0], seq_len)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        emb = self.word_embeddings(input_ids) \
            + self.position_embeddings(position_ids) \
            + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(emb))


class BertPooler(nn.Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, hidden):
        return F.tanh(self.dense(hidden[:, 0]))


class BertModel(nn.Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.config = cfg
        self.embeddings = BertEmbeddings(cfg)
        enc_layer = nn.TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size,
            dropout=cfg.hidden_dropout_prob, activation=cfg.hidden_act,
            attn_dropout=cfg.attention_probs_dropout_prob,
            act_dropout=0.0)
        self.encoder = nn.TransformerEncoder(enc_layer,
                                             cfg.num_hidden_layers)
        self.pooler = BertPooler(cfg)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        if attention_mask is not None and attention_mask.dim() == 2:
            # (B, S) 1/0 -> additive (B, 1, 1, S): keep 0, pad -1e9
            m = attention_mask.float()[:, None, None, :]
            attention_mask = (m - 1.0) * 1e9
        emb = self.embeddings(input_ids, token_type_ids, position_ids)
        seq_out = self.encoder(emb, attention_mask)
        return seq_out, self.pooler(seq_out)


class BertPretrainingHeads(nn.Layer):
    def __init__(self, cfg: BertConfig, embedding_weights=None):
        super().__init__()
        self.transform = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.act = getattr(F, cfg.hidden_act)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size,
                                       epsilon=cfg.layer_norm_eps)
        self.decoder_weight = embedding_weights  # tied to word embeddings
        self.decoder_bias = torch.nn.Parameter(
            torch.zeros(cfg.vocab_size, dtype=torch.float32))
        self.seq_relationship = nn.Linear(cfg.hidden_size, 2)

    def forward(self, sequence_output, pooled_output, masked_positions=None):
        if masked_positions is not None:
            # gather the masked rows BEFORE the vocab projection: the
            # (B*S, V) logits shrink to (B*P, V)
            b, s, h = sequence_output.shape
            flat = sequence_output.reshape(-1, h)
            base = torch.arange(0, b * s, s,
                                device=flat.device).reshape(b, 1)
            idx = masked_positions.long() + base
            sequence_output = flat[idx.reshape(-1)]
        hid = self.layer_norm(self.act(self.transform(sequence_output)))
        # tied softmax: logits = hid @ word_embeddings^T + bias
        logits = F.linear(hid, self.decoder_weight.t(), self.decoder_bias)
        return logits, self.seq_relationship(pooled_output)


class BertForPretraining(nn.Layer):
    """MLM + NSP pretraining objective."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.bert = BertModel(cfg)
        self.cls = BertPretrainingHeads(
            cfg, self.bert.embeddings.word_embeddings.weight)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                masked_positions=None):
        """masked_positions (B, P) selects the MLM prediction rows; the
        logits then come back (B*P, V) instead of (B, S, V), and loss()
        takes labels (B, P)."""
        seq_out, pooled = self.bert(input_ids, token_type_ids,
                                    attention_mask=attention_mask)
        return self.cls(seq_out, pooled, masked_positions)

    def loss(self, prediction_logits, nsp_logits, masked_lm_labels,
             next_sentence_labels, ignore_index=-100):
        """Mean MLM cross entropy over non-ignored positions + NSP cross
        entropy; a 0-d tensor. In a data-parallel step the MLM mean is
        the global batch's: the count of masked positions is summed over
        the ranks (``batch_total``), and this rank's term is scaled by
        the number of ranks, so that the ranks' mean loss and mean
        gradient are the global batch's."""
        vocab = prediction_logits.shape[-1]
        logits2d = prediction_logits.reshape(-1, vocab)
        labels = masked_lm_labels.reshape(-1, 1)
        per_tok = F.softmax_with_cross_entropy(logits2d, labels,
                                               ignore_index=ignore_index)
        mask = (labels != ignore_index).float()
        count, ranks = batch_total(mask.sum())
        mlm = (per_tok * mask).sum() / count.clamp(min=1.0)
        if ranks > 1:
            mlm = mlm * ranks
        return mlm + F.cross_entropy(nsp_logits, next_sentence_labels)


def params_from_jax(named: dict, device="cpu") -> dict:
    """A ``state_dict`` for ``BertForPretraining`` (or ``BertModel``)
    from the JAX model's parameters: ``{name: array}`` as
    ``dict((n, p.numpy()) for n, p in model.named_parameters())`` gives
    them. Names and layouts are the same in both packages; the tied MLM
    decoder weight, which the reference lists once under the word
    embedding's name, is filled in under its second name here. Load with
    ``model.load_state_dict(sd)``."""
    dev = torch.device(device)
    sd = {k: torch.tensor(np.asarray(v, np.float32), device=dev)
          for k, v in named.items()}
    word = "bert.embeddings.word_embeddings.weight"
    if word in sd:
        sd.setdefault("cls.decoder_weight", sd[word])
    return sd

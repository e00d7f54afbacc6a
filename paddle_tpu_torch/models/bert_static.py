"""BERT pretraining as a static program: the encoder, the masked-LM and
next-sentence heads and the Lamb update, appended through the public
static entry points (``fluid.layers``, ``common_ops.run_op`` /
``run_op_multi`` in static mode, ``fluid.optimizer.LambOptimizer``)
with the ops and branch rules of the reference's
``nn/transformer.py`` TransformerEncoderLayer in static mode:

  embeddings   lookup_table_v2 x 3 (word, position, type), elementwise_add,
               layer_norm, dropout
  attention    Q / K / V by fc (mul + elementwise_add), reshape2 and
               transpose2 to (B, heads, S, head dim), fused_attention with
               the padding mask, transpose2 and reshape2 back, then
               fused_out_ln (the out-projection, dropout, residual and LN)
  FFN          fused_ffn_block (gelu, post-LN); in the layers of
               `act_dropout_layers` the composed fc -> gelu -> dropout ->
               fc, then fused_dropout_add_ln (the reference's _ffn and
               _epilogue when the activation dropout is on)
  MLM head     gather of the masked positions, fc + gelu, layer_norm,
               matmul_v2 against the tied word table (trans_y), the output
               bias, softmax_with_cross_entropy and mean
  NSP head     slice of the [CLS] row, fc + tanh, fc to 2,
               softmax_with_cross_entropy and mean

The loss is the sum of the two means. Weights start from BERT's
truncated normal (truncated_gaussian_random in the startup program),
biases at 0 and LN scales at 1. Float32 throughout, as the reference's
static programs are.

``build_bert_pretrain_program(cfg, ...)`` builds it with the port's
entry points; ``api`` swaps in another package's (the tests build the
reference's program with the same code).
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np

from .bert import BertConfig

__all__ = ["BertConfig", "build_bert_pretrain_program", "port_api",
           "bert_pretrain_batch"]


def port_api():
    """The port's static entry points the program is built with."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import common_ops
    from paddle_tpu_torch.fluid import (framework, initializer, layers,
                                        optimizer, param_attr, unique_name)
    return SimpleNamespace(
        enable_static=pt.enable_static, disable_static=pt.disable_static,
        framework=framework, layers=layers, run_op=common_ops.run_op,
        run_op_multi=common_ops.run_op_multi, optimizer=optimizer,
        initializer=initializer, ParamAttr=param_attr.ParamAttr,
        unique_name=unique_name)


@dataclasses.dataclass
class _Parts:
    """The program's parameters and sub-layers, appended through `api`."""
    api: SimpleNamespace
    cfg: BertConfig
    p: float

    def _attr(self, name):
        return self.api.ParamAttr(name=name)

    def weight(self, name, shape):
        init = self.api.initializer.TruncatedNormalInitializer(
            0.0, self.cfg.initializer_range)
        return self.api.layers.create_parameter(
            list(shape), "float32", name=name, default_initializer=init)

    def bias(self, name, n, value=0.0):
        return self.api.layers.create_parameter(
            [n], "float32", name=name, is_bias=True,
            default_initializer=self.api.initializer.ConstantInitializer(
                value))

    def fc(self, x, size, name, act=None, flatten=2):
        init = self.api.initializer.TruncatedNormalInitializer(
            0.0, self.cfg.initializer_range)
        return self.api.layers.fc(
            x, size, num_flatten_dims=flatten,
            param_attr=self.api.ParamAttr(name=name + ".w",
                                          initializer=init),
            bias_attr=self.api.ParamAttr(
                name=name + ".b",
                initializer=self.api.initializer.ConstantInitializer(0.0)),
            act=act)

    def layer_norm(self, x, name):
        return self.api.layers.layer_norm(
            x, begin_norm_axis=len(x.shape) - 1,
            epsilon=self.cfg.layer_norm_eps,
            param_attr=self._attr(name + ".scale"),
            bias_attr=self._attr(name + ".bias"))

    def dropout(self, x, p):
        return self.api.layers.dropout(
            x, p, dropout_implementation="upscale_in_train")

    def heads(self, x, b, s):
        """(B, S, H) -> (B, heads, S, head dim)."""
        nh = self.cfg.num_attention_heads
        x = self.api.layers.reshape(
            x, [b, s, nh, self.cfg.hidden_size // nh])
        return self.api.layers.transpose(x, [0, 2, 1, 3])

    def encoder_layer(self, h, mask, b, s, i, act_dropout):
        cfg, run_op, p = self.cfg, self.api.run_op, self.p
        H, I = cfg.hidden_size, cfg.intermediate_size
        pre = f"encoder.{i}"
        q = self.heads(self.fc(h, H, pre + ".q"), b, s)
        k = self.heads(self.fc(h, H, pre + ".k"), b, s)
        v = self.heads(self.fc(h, H, pre + ".v"), b, s)
        a = run_op("fused_attention", {"Q": q, "K": k, "V": v, "Mask": mask},
                   {"causal": False, "dropout_p": p})
        a = self.api.layers.transpose(a, [0, 2, 1, 3])
        a = self.api.layers.reshape(a, [b, s, H])
        h = run_op("fused_out_ln", {
            "X": a, "W": self.weight(pre + ".out.w", (H, H)),
            "B": self.bias(pre + ".out.b", H), "Residual": h,
            "Scale": self.bias(pre + ".ln1.scale", H, 1.0),
            "Bias": self.bias(pre + ".ln1.bias", H)},
            {"dropout_p": p, "epsilon": cfg.layer_norm_eps})
        if act_dropout is None:
            return run_op("fused_ffn_block", {
                "X": h, "W1": self.weight(pre + ".ffn1.w", (H, I)),
                "B1": self.bias(pre + ".ffn1.b", I),
                "W2": self.weight(pre + ".ffn2.w", (I, H)),
                "B2": self.bias(pre + ".ffn2.b", H), "Residual": h,
                "Scale": self.bias(pre + ".ln2.scale", H, 1.0),
                "Bias": self.bias(pre + ".ln2.bias", H)},
                {"activation": "gelu", "norm": "post", "dropout_p": p,
                 "epsilon": cfg.layer_norm_eps})
        f = self.fc(h, I, pre + ".ffn1", act="gelu")
        f = self.dropout(f, act_dropout)
        f = self.fc(f, H, pre + ".ffn2")
        return run_op("fused_dropout_add_ln", {
            "X": f, "Residual": h,
            "Scale": self.bias(pre + ".ln2.scale", H, 1.0),
            "Bias": self.bias(pre + ".ln2.bias", H)},
            {"dropout_p": p, "epsilon": cfg.layer_norm_eps})


def build_bert_pretrain_program(cfg: BertConfig, batch: int, seq: int,
                                n_mask: int, lr: float = 1e-4,
                                dropout: float | None = None,
                                act_dropout_layers=(), act_dropout=0.1,
                                api=None):
    """(main, startup, loss) of BERT pretraining at (batch, seq) with
    `n_mask` masked positions over the batch, minimised by Lamb at `lr`.
    `dropout` (default cfg.hidden_dropout_prob) is every dropout's
    probability; the layers in `act_dropout_layers` take the composed
    FFN with an activation dropout of `act_dropout`. The data:
    input_ids, pos_ids, type_ids (B, S) int64; attn_mask
    (B, 1, 1, S) float32, additive (0 keep, -1e4 padding); masked_pos
    (M,) int64 rows of the flattened (B * S) sequence; masked_labels
    (M, 1) and nsp_labels (B, 1) int64."""
    api = api or port_api()
    p = cfg.hidden_dropout_prob if dropout is None else float(dropout)
    bld = _Parts(api, cfg, p)
    L = api.layers
    H, B, S = cfg.hidden_size, batch, seq
    api.enable_static()
    try:
        with api.unique_name.guard():
            main, startup = api.framework.Program(), api.framework.Program()
            with api.framework.program_guard(main, startup):
                ids = L.data("input_ids", [B, S], "int64")
                pos = L.data("pos_ids", [B, S], "int64")
                typ = L.data("type_ids", [B, S], "int64")
                mask = L.data("attn_mask", [B, 1, 1, S], "float32")
                mpos = L.data("masked_pos", [n_mask], "int64")
                mlab = L.data("masked_labels", [n_mask, 1], "int64")
                nlab = L.data("nsp_labels", [B, 1], "int64")
                word = bld.weight("word_embeddings",
                                  (cfg.vocab_size, H))
                emb = [api.run_op("lookup_table_v2", {"W": w, "Ids": i})
                       for w, i in (
                           (word, ids),
                           (bld.weight("position_embeddings",
                                       (cfg.max_position_embeddings, H)),
                            pos),
                           (bld.weight("token_type_embeddings",
                                       (cfg.type_vocab_size, H)), typ))]
                h = L.elementwise_add(L.elementwise_add(emb[0], emb[1]),
                                      emb[2])
                h = bld.dropout(bld.layer_norm(h, "embeddings.ln"), p)
                for i in range(cfg.num_hidden_layers):
                    h = bld.encoder_layer(
                        h, mask, B, S, i,
                        act_dropout if i in act_dropout_layers else None)
                # masked-LM head over the masked rows
                flat = L.reshape(h, [B * S, H])
                m = L.gather(flat, mpos)
                m = bld.fc(m, H, "mlm.transform", act="gelu", flatten=1)
                m = bld.layer_norm(m, "mlm.ln")
                logits = api.run_op("matmul_v2", {"X": m, "Y": word},
                                    {"trans_y": True})
                logits = L.elementwise_add(
                    logits, bld.bias("mlm.out.b", cfg.vocab_size))
                mlm = L.mean(L.softmax_with_cross_entropy(logits, mlab))
                # next-sentence head on [CLS]
                cls = L.slice(h, axes=[1], starts=[0], ends=[1])
                pooled = bld.fc(cls, H, "pooler", act="tanh", flatten=1)
                nsp_logits = bld.fc(pooled, 2, "nsp", flatten=1)
                nsp = L.mean(L.softmax_with_cross_entropy(nsp_logits, nlab))
                loss = L.elementwise_add(mlm, nsp)
                api.optimizer.LambOptimizer(learning_rate=lr).minimize(loss)
    finally:
        api.disable_static()
    return main, startup, loss


def bert_pretrain_batch(cfg: BertConfig, batch: int, seq: int, n_mask: int,
                        seed: int = 0, pad_from: int | None = None) -> dict:
    """A feed for the program, from `seed`: random tokens, positions 0..S-1,
    segment B from the middle, the rows after `pad_from` (default: the
    last quarter of every other row) masked out as padding, `n_mask`
    distinct masked positions among the kept tokens with random labels,
    random next-sentence labels."""
    rng = np.random.RandomState(seed)
    B, S = batch, seq
    ids = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int64)
    pos = np.tile(np.arange(S, dtype=np.int64), (B, 1))
    typ = np.zeros((B, S), np.int64)
    typ[:, S // 2:] = 1
    keep = np.ones((B, S), bool)
    cut = S - S // 4 if pad_from is None else pad_from
    keep[1::2, cut:] = False
    mask = np.where(keep, 0.0, -1e4).astype(np.float32)[:, None, None, :]
    kept = np.flatnonzero(keep.reshape(-1))
    mpos = np.sort(rng.choice(kept, n_mask, replace=False)).astype(np.int64)
    return {"input_ids": ids, "pos_ids": pos, "type_ids": typ,
            "attn_mask": mask, "masked_pos": mpos,
            "masked_labels": rng.randint(0, cfg.vocab_size,
                                         (n_mask, 1)).astype(np.int64),
            "nsp_labels": rng.randint(0, 2, (B, 1)).astype(np.int64)}

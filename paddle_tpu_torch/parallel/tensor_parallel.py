"""Megatron-style tensor parallelism of the GPT blocks, embedding and
head over the "tp" axis (the port's form of the reference's
``gpt_param_specs`` under GSPMD).

The reference annotates the weights and lets XLA partition the matmuls
and insert the all-reduces. The port runs one process per tp rank, each
holding its part of every split leaf (``models.gpt.shard_params``), and
makes the collectives explicit with a conjugate pair of autograd
functions, so that a replicated activation gets the same gradient on
every tp rank:

  * ``copy_to_tp`` at the input of the column-parallel products
    (identity forward, all-reduce backward);
  * ``reduce_from_tp`` after the row-parallel partial sums (all-reduce
    forward, identity backward).

A block (``tp_block_fn``):
  * attention: q, k, v are column-parallel products (H/tp whole heads
    a rank) and flash runs on the rank's heads;
  * the out sub-block runs ``fused_out_ln`` as a partial on each rank,
    ``dropout(a_r @ wo_r + b_r)`` with ``b_r = bo`` on tp rank 0 and 0
    elsewhere, a zero residual and the same dropout seed on every rank
    (the mask hashes the global (row, col), the same on every rank);
    z = x + sum over tp, the residual added outside the reduction; the
    kernel's h (LN of a partial) is unused and LN2 of z is the row-8
    ``fused_layer_norm`` kernel;
  * the FFN sub-block runs ``fused_ffn_ln(h, w_up_r, b_up_r, w_down_r,
    b_down [r = 0], 0, norm="none")`` a rank; out = z + sum over tp.
Replicated parameters used on tp rank 0 only (bo, b_down) have their
gradient summed over tp by the train step before the clip.

An expert block (cfg.num_experts > 0) is the reference's composed
chain: its out-projection's tp partials are float32 products summed
over tp before they round and take bo (the unsplit block's rounding
points, on which top-1 routing in the later layers depends; bo is then
replicated and its gradient not summed), then ``parallel/moe.py``'s
``moe_ffn`` on the rank's experts and columns. With attn_impl "ring" a
tp rank ring-attends its H/tp heads over the sp group.

The embedding is a vocab-parallel lookup (ids outside the rank's rows
masked, then a sum over tp); the head is vocab-parallel logits with a
distributed ``logsumexp - gold`` in float32 (max, sum of exponentials
and the gold logit each reduced over tp).

With tp = 1 every function is the single-device model's own code.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ..models import gpt as G
from ..ops.fused_block import fused_ffn_ln, fused_out_ln, gelu_tanh
from ..ops.layer_norm import fused_layer_norm
from .comm import Comm

__all__ = ["TP", "copy_to_tp", "reduce_from_tp", "tp_embed", "tp_block_fn",
           "tp_block_body", "tp_head_loss"]


@dataclasses.dataclass
class TP:
    """A rank's place on the tp axis: its process group (None when the
    axis has one rank), index and the axis size; ``comm`` times the
    all-reduces under `kind` ("tp"; the MoE FFN's (ep, tp) pair uses
    the same conjugate functions under "ep")."""
    group: object = None
    rank: int = 0
    size: int = 1
    comm: Comm = dataclasses.field(default_factory=Comm)
    kind: str = "tp"

    def all_reduce(self, t, op=dist.ReduceOp.SUM):
        return self.comm.all_reduce(t, self.group, self.kind, op)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return ctx.tp.all_reduce(dy.contiguous().clone()), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return tp.all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, dy):
        return dy, None


def copy_to_tp(x, tp: TP):
    """Identity forward, gradient summed over tp in the backward."""
    return x if tp.size == 1 else _CopyToTP.apply(x, tp)


def reduce_from_tp(x, tp: TP):
    """Sum over tp in the forward, identity backward."""
    return x if tp.size == 1 else _ReduceFromTP.apply(x, tp)


def tp_embed(params, ids, cfg: G.GPTConfig, tp: TP, pos0: int = 0):
    """wte[ids] + wpe[pos0 : pos0 + T] with this rank's vocabulary rows
    of wte; the model's ``_embed`` at tp = 1."""
    if tp.size == 1:
        return G._embed(params, ids, cfg, pos0)
    T = pos0 + ids.shape[-1]
    if T > params["wpe"].shape[0]:
        raise ValueError(
            f"sequence length {T} exceeds max_position_embeddings="
            f"{params['wpe'].shape[0]}")
    wte = params["wte"]
    rows = wte.shape[0]
    local = torch.as_tensor(ids, device=wte.device).long() - tp.rank * rows
    inside = (local >= 0) & (local < rows)
    e = wte[local.clamp(0, rows - 1)] * inside[..., None].to(wte.dtype)
    x = reduce_from_tp(e, tp) + params["wpe"][pos0:T]
    if cfg.amp_dtype:
        x = x.to(getattr(torch, cfg.amp_dtype))
    return x


def tp_head_loss(params, x, ids, cfg: G.GPTConfig, tp: TP, labels=None,
                 count=None):
    """Mean next-token cross entropy of the final hidden states x [B, T,
    D] against ids [B, T] (``gpt_loss``): final LN, then logits against
    this rank's vocabulary rows in float32 and a logsumexp - gold
    reduced over tp. A sequence shard passes its `labels` [B, T'] (the
    next tokens of its first T' positions, T' = T or T - 1) and the
    global term `count`: the result is its terms' sum over `count`."""
    if labels is None:
        labels = ids[:, 1:]
    labels = torch.as_tensor(labels, device=x.device).long()
    n = labels.shape[1]
    if tp.size == 1:
        logits = G._head(params, x, cfg)[:, :n]
        terms = torch.logsumexp(logits, -1) - torch.gather(
            logits, -1, labels[..., None])[..., 0]
    else:
        h = G._ln(x, params["lnf_s"], params["lnf_b"], cfg.layer_norm_eps)
        h = copy_to_tp(h, tp)
        wte = params["wte"]
        rows = wte.shape[0]
        logits = (h.float() @ wte.float().T)[:, :n]
        labels = labels - tp.rank * rows
        m = logits.detach().amax(-1)
        tp.all_reduce(m, dist.ReduceOp.MAX)
        sumexp = reduce_from_tp(torch.exp(logits - m[..., None]).sum(-1),
                                tp)
        inside = (labels >= 0) & (labels < rows)
        gold = torch.gather(logits, -1,
                            labels.clamp(0, rows - 1)[..., None])
        gold = reduce_from_tp(gold[..., 0] * inside.to(gold.dtype), tp)
        terms = torch.log(sumexp) + m - gold
    return torch.mean(terms) if count is None else terms.sum() / count


def _tail(p, a2, x2, cfg: G.GPTConfig, tp: TP, drop, seeds):
    """The decoder tail (``models.gpt.decoder_tail``) over tp: partial
    sub-blocks a rank, each sum taken after, the residual outside."""
    cdt = a2.dtype
    eps = cfg.layer_norm_eps
    first = tp.rank == 0
    bo = p["bo"] if first else torch.zeros_like(p["bo"])
    b_down = p["b_down"] if first else torch.zeros_like(p["b_down"])
    wo, w_up, b_up, w_down = (p[k].to(cdt) for k in
                              ("wo", "w_up", "b_up", "w_down"))
    zero = torch.zeros(x2.shape, dtype=cdt, device=x2.device)
    if cfg.fused_blocks:
        zr, _ = fused_out_ln(a2, wo, bo.to(cdt), zero, p["ln2_s"],
                             p["ln2_b"], p=drop, eps=eps, seed=seeds[0])
    else:
        zr = G._drop(a2 @ wo + bo.to(cdt), drop, seeds[0])
    z = (x2.float() + reduce_from_tp(zr.float(), tp)).to(x2.dtype)
    if cfg.fused_blocks:
        h = fused_layer_norm(z, p["ln2_s"], p["ln2_b"], eps)[0]
    else:
        h = G._ln(z, p["ln2_s"], p["ln2_b"], eps)
    h = copy_to_tp(h.to(cdt), tp)
    if cfg.fused_blocks:
        outr = fused_ffn_ln(h, w_up, b_up, w_down, b_down.to(cdt), zero,
                            p=drop, eps=eps, seed=seeds[1])
    else:
        u = gelu_tanh(h @ w_up + b_up)
        outr = G._drop(u @ w_down + b_down.to(cdt), drop, seeds[1])
    return (z.float() + reduce_from_tp(outr.float(), tp)).to(z.dtype)


def tp_block_fn(p: dict, x, cfg: G.GPTConfig, tp: TP, seeds=None):
    """One pre-LN decoder block on [B, T, D] with this rank's parts of
    the split leaves (``gpt_block_fn`` at tp = 1). Returns (x, aux)."""
    if tp.size == 1:
        return G.gpt_block_fn(p, x, cfg, seeds)
    if cfg.num_heads % tp.size:
        raise ValueError(f"num_heads={cfg.num_heads} not divisible by "
                         f"tp={tp.size}")
    cdt = getattr(torch, cfg.amp_dtype) if cfg.amp_dtype else x.dtype

    def c(a):
        return a.to(cdt)

    h = G._ln(x, p["ln1_s"], p["ln1_b"], cfg.layer_norm_eps)
    h = c(copy_to_tp(h, tp))
    q = h @ c(p["wq"]) + c(p["bq"])
    k = h @ c(p["wk"]) + c(p["bk"])
    v = h @ c(p["wv"]) + c(p["bv"])
    a = G._causal_attention(q, k, v, cfg.num_heads // tp.size,
                            cfg.attn_impl)
    B, T, D = x.shape
    drop = cfg.dropout if seeds is not None else 0.0
    if cfg.num_experts > 0:
        return G.moe_tail(p, c(a), x, cfg, drop, seeds or (0, 0),
                          matmul=lambda a, w: reduce_from_tp(
                              a.float() @ w.float(), tp).to(a.dtype))
    return _tail(p, c(a).reshape(B * T, -1), x.reshape(B * T, D), cfg, tp,
                 drop, seeds or (0, 0)).reshape(B, T, D), None


def tp_block_body(cfg: G.GPTConfig, tp: TP):
    """(h, blk, seeds=None) -> (h, aux) for one layer, recomputed in the
    backward when cfg.remat (``models.gpt.block_body``); the recompute
    repeats the forward's collectives on every rank alike."""
    if tp.size == 1:
        return G.block_body(cfg)

    def body(h, blk, seeds=None):
        if cfg.remat and torch.is_grad_enabled():
            return checkpoint(tp_block_fn, blk, h, cfg, tp, seeds,
                              use_reentrant=False)
        return tp_block_fn(blk, h, cfg, tp, seeds)
    return body

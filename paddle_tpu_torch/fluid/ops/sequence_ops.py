"""Sequence ops (counterpart of ``paddle_tpu/fluid/ops/sequence_ops.py``):
the LoD-free tier, on torch tensors.

A ragged batch is dense [B, T, ...] with a ``Length`` vector (or, for
``segment_pool``, segment ids), as in the reference: masks are made on
the fly. ``sequence_unpad`` and ``sequence_expand`` have data-dependent
output shapes and run on concrete values, as the reference's eager
path does.

The ``rnn`` op (LSTM, GRU, RNN_TANH / RNN_RELU; multi-layer,
bidirectional, length-masked) is composed as the reference's: the input
projection of a layer and direction is one product over all time steps,
then the recurrence runs step by step in the gate layouts of
``_lstm_step`` / ``_gru_step`` (i|f|g|o and r|z|n). Past a sequence's
length the state is carried and the output is 0; the reverse direction
runs over each sequence's valid prefix reversed. The CPU and the card
run the same code; cuDNN's fused RNN is not used (its masking and
rounding differ from the reference's).
"""
from __future__ import annotations

import torch

from ..core import torch_dtype
from ..registry import register, same_shape_as
from .common import out, x


def _len_mask(lengths, maxlen):
    """[B] lengths -> [B, maxlen] bool mask."""
    return torch.arange(maxlen, device=lengths.device)[None, :] \
        < lengths.reshape(-1, 1)


def _bshape(v, lead):
    """`lead` + ones for the trailing dims of v past its first two."""
    return tuple(lead) + (1,) * (v.dim() - 2)


def _full_lengths(v):
    return torch.full((v.shape[0],), v.shape[1], dtype=torch.int64,
                      device=v.device)


# ---------------------------------------------------------------------------
# masking / padding
# ---------------------------------------------------------------------------

def _seq_mask_infer(op):
    v = op.invar("X")
    maxlen = op.attr("maxlen", -1)
    if v is None or v.shape is None or maxlen is None or maxlen < 0:
        return
    for name in op.output("Y"):
        op.block.create_var(name=name, shape=tuple(v.shape) + (maxlen,),
                            dtype=op.attr("out_dtype", "int64"))


@register("sequence_mask", infer_shape=_seq_mask_infer, grad=None,
          attrs={"maxlen": -1, "out_dtype": "int64"})
def _sequence_mask(ctx, ins, attrs):
    lens = x(ins)
    maxlen = attrs.get("maxlen", -1)
    if maxlen is None or maxlen < 0:
        maxlen = int(lens.max())
    m = torch.arange(maxlen, device=lens.device) < lens[..., None]
    return {"Y": [m.to(torch_dtype(attrs.get("out_dtype", "int64")))]}


@register("sequence_pad", no_grad_slots=("Length",),
          no_grad_out_slots=("Length",))
def _sequence_pad(ctx, ins, attrs):
    """Flat rows [sum(len), D] + lengths -> [B, maxlen, D] (+ Length out).
    attrs: padded_length, pad_value."""
    v, lens = x(ins, "X"), x(ins, "Length")
    maxlen = attrs.get("padded_length", -1)
    if maxlen is None or maxlen < 0:
        maxlen = int(lens.max())
    pad = attrs.get("pad_value", 0.0)
    B = lens.shape[0]
    starts = torch.cumsum(lens, 0) - lens
    pos = torch.arange(maxlen, device=v.device)[None, :]
    idx = (starts[:, None] + pos).clamp(0, v.shape[0] - 1)
    valid = pos < lens[:, None]
    rows = v[idx.reshape(-1).long()].reshape((B, maxlen) + tuple(v.shape[1:]))
    rows = torch.where(valid.reshape((B, maxlen) + (1,) * (v.dim() - 1)),
                       rows, torch.full_like(rows, pad))
    return {"Out": [rows], "Length": [lens]}


@register("sequence_unpad", grad=None, no_grad_slots=("Length",))
def _sequence_unpad(ctx, ins, attrs):
    """[B, T, ...] + lengths -> flat [sum(len), ...] (data-dependent
    shape: concrete values)."""
    v, lens = x(ins, "X"), x(ins, "Length")
    return out(torch.cat([v[b, :int(n)] for b, n in
                          enumerate(lens.reshape(-1).tolist())], 0))


# ---------------------------------------------------------------------------
# masked reductions / transforms
# ---------------------------------------------------------------------------

def _seq_pool_infer(op):
    v = op.invar("X")
    if v is None or v.shape is None:
        return
    for name in op.output("Out"):
        op.block.create_var(name=name, shape=(v.shape[0],) + tuple(
            v.shape[2:]), dtype=v.dtype)


@register("sequence_pool", infer_shape=_seq_pool_infer,
          no_grad_slots=("Length",),
          attrs={"pooltype": "AVERAGE", "pad_value": 0.0})
def _sequence_pool(ctx, ins, attrs):
    """[B, T, ...] (+ optional Length) -> [B, ...] by SUM/AVERAGE/SQRT/
    MAX/MIN/LAST/FIRST over the valid prefix; an empty sequence gives
    pad_value."""
    v = x(ins, "X")
    lens = x(ins, "Length")
    B, T = v.shape[0], v.shape[1]
    if lens is None:
        lens = _full_lengths(v)
    lens = lens.reshape(-1)
    m = _len_mask(lens, T).reshape(_bshape(v, (B, T)))
    pt = attrs.get("pooltype", "AVERAGE").upper()
    tail = (-1,) + (1,) * (v.dim() - 2)
    denom = torch.clamp(lens, min=1).reshape(tail)
    zero = torch.zeros_like(v)
    if pt == "SUM":
        r = torch.where(m, v, zero).sum(1)
    elif pt == "AVERAGE":
        r = torch.where(m, v, zero).sum(1) / denom
    elif pt == "SQRT":
        r = torch.where(m, v, zero).sum(1) / torch.sqrt(denom.to(v.dtype))
    elif pt == "MAX":
        r = torch.where(m, v, torch.full_like(v, -float("inf"))).amax(1)
    elif pt == "MIN":
        r = torch.where(m, v, torch.full_like(v, float("inf"))).amin(1)
    elif pt == "LAST":
        idx = torch.clamp(lens - 1, min=0).reshape(_bshape(v, (B, 1)))
        r = torch.gather(v, 1, idx.expand((B, 1) + tuple(v.shape[2:])))[:, 0]
    elif pt == "FIRST":
        r = v[:, 0]
    else:
        raise ValueError(f"unknown pooltype {pt!r}")
    empty = (lens == 0).reshape(tail)
    return out(torch.where(empty, torch.full_like(
        r, attrs.get("pad_value", 0.0)), r))


@register("sequence_softmax", no_grad_slots=("Length",))
def _sequence_softmax(ctx, ins, attrs):
    """Masked softmax over the time dim of [B, T] (or [B, T, ...])."""
    v = x(ins, "X")
    lens = x(ins, "Length")
    if lens is None:
        lens = _full_lengths(v)
    m = _len_mask(lens.reshape(-1), v.shape[1]).reshape(
        _bshape(v, v.shape[:2]))
    z = torch.where(m, v, torch.full_like(v, -float("inf")))
    return out(torch.where(m, torch.softmax(z, 1), torch.zeros_like(v)))


def _reverse(v, lens):
    """Each sequence's valid prefix reversed; padding stays in place."""
    T = v.shape[1]
    if lens is None:
        return torch.flip(v, [1])
    lens = lens.reshape(-1, 1)
    pos = torch.arange(T, device=v.device)[None, :]
    idx = torch.where(pos < lens, lens - 1 - pos, pos)
    return torch.gather(v, 1, idx.reshape(_bshape(v, idx.shape)).expand(
        v.shape))


@register("sequence_reverse", infer_shape=same_shape_as("X"),
          no_grad_slots=("Length",))
def _sequence_reverse(ctx, ins, attrs):
    return out(_reverse(x(ins, "X"), x(ins, "Length")))


@register("sequence_expand", grad=None, no_grad_slots=("RefLength",))
def _sequence_expand(ctx, ins, attrs):
    """Row b of X repeated RefLength[b] times (data-dependent shape)."""
    v, ref = x(ins, "X"), x(ins, "RefLength")
    return out(torch.repeat_interleave(v, ref.reshape(-1).long(), dim=0))


# ---------------------------------------------------------------------------
# segment ops
# ---------------------------------------------------------------------------

@register("segment_pool", no_grad_slots=("SegmentIds",),
          attrs={"pooltype": "SUM", "num_segments": -1})
def _segment_pool(ctx, ins, attrs):
    """Pool rows of X [N, ...] by SegmentIds [N] into [num_segments, ...];
    an empty segment sums to 0 and maxes (mins) to -inf (inf), as the
    reference's segment reductions."""
    v, seg = x(ins, "X"), x(ins, "SegmentIds")
    n = attrs.get("num_segments", -1)
    if n is None or n < 0:
        n = int(seg.max()) + 1
    seg = seg.reshape(-1).long()
    pt = attrs.get("pooltype", "SUM").upper()
    shape = (n,) + tuple(v.shape[1:])
    if pt in ("SUM", "MEAN"):
        r = torch.zeros(shape, dtype=v.dtype, device=v.device) \
            .index_add(0, seg, v)
        if pt == "MEAN":
            c = torch.zeros(n, dtype=v.dtype, device=v.device).index_add(
                0, seg, torch.ones_like(seg, dtype=v.dtype))
            r = r / torch.clamp(c, min=1).reshape((-1,) + (1,) * (v.dim()
                                                                 - 1))
    elif pt in ("MAX", "MIN"):
        fill = -float("inf") if pt == "MAX" else float("inf")
        idx = seg.reshape((-1,) + (1,) * (v.dim() - 1)).expand(v.shape)
        r = torch.full(shape, fill, dtype=v.dtype, device=v.device) \
            .scatter_reduce(0, idx, v, "amax" if pt == "MAX" else "amin")
    else:
        raise ValueError(f"unknown pooltype {pt!r}")
    return out(r)


# ---------------------------------------------------------------------------
# rnn op: the recurrence step by step
# ---------------------------------------------------------------------------

def rnn_weight_shapes(mode, input_size, hidden_size, num_layers=1,
                      ndir=1):
    """Shapes of the `rnn` op's WeightList, in slot order: per (layer,
    direction) four arrays (w_ih [G*H, in], w_hh [G*H, H], b_ih [G*H],
    b_hh [G*H])."""
    G = {"LSTM": 4, "GRU": 3}.get(mode, 1)
    H = hidden_size
    shapes = []
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else H * ndir
        for _ in range(ndir):
            shapes += [(G * H, in_sz), (G * H, H), (G * H,), (G * H,)]
    return shapes


def _lstm_step(xw, h, c, w_hh, b_hh):
    g = xw + h @ w_hh.T + b_hh
    i, f, gg, o = torch.chunk(g, 4, dim=-1)
    c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
    h2 = torch.sigmoid(o) * torch.tanh(c2)
    return h2, c2


def _gru_step(xw, h, w_hh, b_hh):
    # gate layout r|z|n
    hw = h @ w_hh.T + b_hh
    xr, xz, xn = torch.chunk(xw, 3, dim=-1)
    hr, hz, hn = torch.chunk(hw, 3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1 - z) * n + z * h


def _rnn_single(v, lens, h0, c0, w_ih, w_hh, b_ih, b_hh, mode, reverse):
    """One direction of one layer. v [B,T,D] -> (out [B,T,H], h_n, c_n)."""
    B, T, _ = v.shape
    if reverse:
        v = _reverse(v, lens)
    xw = (v @ w_ih.T + b_ih).transpose(0, 1)             # [T, B, G*H]
    mask = (torch.ones((T, B, 1), dtype=torch.bool, device=v.device)
            if lens is None else _len_mask(lens, T).T[..., None])
    h, c = h0, c0
    ys = []
    for t in range(T):
        xt, keep = xw[t], mask[t]
        if mode == "LSTM":
            h2, c2 = _lstm_step(xt, h, c, w_hh, b_hh)
        elif mode == "GRU":
            h2, c2 = _gru_step(xt, h, w_hh, b_hh), c
        elif mode == "RNN_RELU":
            h2, c2 = torch.relu(xt + h @ w_hh.T + b_hh), c
        else:  # RNN_TANH
            h2, c2 = torch.tanh(xt + h @ w_hh.T + b_hh), c
        h = torch.where(keep, h2, h)
        c = torch.where(keep, c2, c)
        ys.append(torch.where(keep, h, torch.zeros_like(h)))
    outp = torch.stack(ys, 1)                            # [B, T, H]
    if reverse:
        outp = _reverse(outp, lens)
    return outp, h, c


def _rnn_infer(op):
    v = op.invar("Input")
    if v is None or v.shape is None:
        return
    H = op.attr("hidden_size", 0)
    L = op.attr("num_layers", 1)
    ndir = 2 if op.attr("is_bidirec", False) else 1
    B, T = v.shape[0], v.shape[1]
    for name in op.output("Out"):
        op.block.create_var(name=name, shape=(B, T, H * ndir),
                            dtype=v.dtype)
    for name in op.output("State"):
        op.block.create_var(name=name, shape=(L * ndir, B, H),
                            dtype=v.dtype)


@register("rnn", infer_shape=_rnn_infer, no_grad_slots=("SequenceLength",),
          stochastic=True,
          attrs={"mode": "LSTM", "hidden_size": 0, "num_layers": 1,
                 "is_bidirec": False, "dropout_prob": 0.0, "is_test": False})
def _rnn(ctx, ins, attrs):
    """Multi-layer (bi)directional recurrent net: Input [B,T,D],
    WeightList = per (layer, direction) four tensors (w_ih [G*H, in],
    w_hh [G*H, H], b_ih, b_hh), PreState h0 (+c0) each [L*ndir, B, H].
    Dropout between layers draws its masks from the op's generator (the
    grad op's re-run draws the same ones)."""
    v = x(ins, "Input")
    lens = x(ins, "SequenceLength")
    if lens is not None:
        lens = lens.reshape(-1)
    weights = ins.get("WeightList") or []
    pre = ins.get("PreState") or []
    mode = attrs.get("mode", "LSTM")
    L = attrs.get("num_layers", 1)
    bi = attrs.get("is_bidirec", False)
    ndir = 2 if bi else 1
    p = attrs.get("dropout_prob", 0.0)
    is_test = attrs.get("is_test", False) or (ctx is not None and
                                              ctx.is_test)
    B = v.shape[0]
    H = attrs["hidden_size"] or weights[1].shape[-1]
    h0 = pre[0] if pre else torch.zeros((L * ndir, B, H), dtype=v.dtype,
                                        device=v.device)
    c0 = pre[1] if len(pre) > 1 else torch.zeros_like(h0)
    gen = ctx.generator(attrs) if p and not is_test and ctx is not None \
        else None

    inp = v
    h_out, c_out = [], []
    for layer in range(L):
        outs = []
        for d in range(ndir):
            k = layer * ndir + d
            w_ih, w_hh, b_ih, b_hh = weights[4 * k: 4 * k + 4]
            o, hn, cn = _rnn_single(inp, lens, h0[k], c0[k], w_ih, w_hh,
                                    b_ih, b_hh, mode, reverse=(d == 1))
            outs.append(o)
            h_out.append(hn)
            c_out.append(cn)
        inp = torch.cat(outs, -1) if bi else outs[0]
        if gen is not None and layer < L - 1:
            keep = torch.rand(inp.shape, generator=gen,
                              device=inp.device) >= p
            inp = torch.where(keep, inp / (1.0 - p), torch.zeros_like(inp))
    state = [torch.stack(h_out)]
    state.append(torch.stack(c_out) if mode == "LSTM"
                 else torch.zeros_like(state[0]))
    return {"Out": [inp], "State": state}

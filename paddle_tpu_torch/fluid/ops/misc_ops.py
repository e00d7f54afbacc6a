"""Long-tail op groups (counterpart of
``paddle_tpu/fluid/ops/misc_ops.py``): vision extras (conv_shift, lrn,
data_norm, pixel and channel shuffles, the temporal shift, grid sampling
and affine grids, unfold, spatial pyramid pooling, norm), sequence
extras (edit distance, CTC alignment, im2sequence, the lookahead row
convolution), the GRU and LSTM step units, the position encoding, the
ranking and distillation losses, the proximal optimizers and DGC's
clip, the precision-recall and pair metrics, anchors, histograms, the
masked select and the parameter-server id ops, on torch tensors.
Gradients come from the auto grad op unless an op has none.

Ops whose output size depends on the data (masked_select, split_ids,
merge_ids) or that walk a dynamic programme over few integer sequences
(edit_distance) compute on concrete values and return tensors on the
input's device, as the reference's eager path does.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..registry import register, require, same_shape_as
from .common import out, x


# ---------------------------------------------------------------------------
# conv / vision extras
# ---------------------------------------------------------------------------

@register("conv_shift", infer_shape=same_shape_as("X"))
def _conv_shift(ctx, ins, attrs):
    """Circular correlation: Out[i,j] = sum_k X[i, (j+k-M//2) mod N] Y[i,k]."""
    a, b = x(ins, "X"), x(ins, "Y")
    N, M = a.shape[1], b.shape[1]
    idx = (torch.arange(N, device=a.device)[:, None]
           + torch.arange(M, device=a.device)[None, :] - M // 2) % N
    return out(torch.einsum("bnm,bm->bn", a[:, idx], b))


@register("lrn", infer_shape=same_shape_as("X"),
          no_grad_out_slots=("MidOut",),
          attrs={"n": 5, "k": 2.0, "alpha": 1e-4, "beta": 0.75})
def _lrn(ctx, ins, attrs):
    """Local response normalisation across channels."""
    v = x(ins, "X")
    n, k, alpha, beta = (attrs["n"], attrs["k"], attrs["alpha"],
                         attrs["beta"])
    half = n // 2
    pad = F.pad(torch.square(v), (0, 0, 0, 0, half, n - 1 - half))
    acc = sum(pad[:, i:i + v.shape[1]] for i in range(n))
    mid = k + alpha * acc
    return {"Out": [v / mid ** beta], "MidOut": [mid]}


@register("data_norm", no_grad_slots=("BatchSize", "BatchSum",
                                      "BatchSquareSum"),
          no_grad_out_slots=("Means", "Scales"),
          attrs={"epsilon": 1e-4, "slot_dim": -1})
def _data_norm(ctx, ins, attrs):
    """y = (x - mean) / scale from the running batch size, sum and
    square-sum counters (global-statistics normalisation of CTR
    models)."""
    v = x(ins, "X").float()
    bsz = x(ins, "BatchSize").float()
    bsum = x(ins, "BatchSum").float()
    bsq = x(ins, "BatchSquareSum").float()
    means = bsum / torch.clamp(bsz, min=1e-4)
    scales = torch.sqrt(torch.clamp(bsz, min=1e-4)
                        / torch.clamp(bsq, min=attrs["epsilon"]))
    return {"Y": [(v - means) * scales], "Means": [means],
            "Scales": [scales]}


@register("pixel_shuffle", attrs={"upscale_factor": 1,
                                  "data_format": "NCHW"})
def _pixel_shuffle(ctx, ins, attrs):
    v = x(ins, "X")
    r = attrs["upscale_factor"]
    N, C, H, W = v.shape
    v = v.reshape(N, C // (r * r), r, r, H, W).permute(0, 1, 4, 2, 5, 3)
    return out(v.reshape(N, C // (r * r), H * r, W * r))


@register("shuffle_channel", attrs={"group": 1})
def _shuffle_channel(ctx, ins, attrs):
    v = x(ins, "X")
    g = attrs["group"]
    N, C, H, W = v.shape
    return out(v.reshape(N, g, C // g, H, W).transpose(1, 2)
               .reshape(N, C, H, W))


@register("temporal_shift", attrs={"seg_num": 1, "shift_ratio": 0.25})
def _temporal_shift(ctx, ins, attrs):
    """The temporal shift: within each segment the first C * ratio
    channels move back one step in time and the next C * ratio forward."""
    v = x(ins, "X")
    T = attrs["seg_num"]
    NT, C, H, W = v.shape
    c1 = int(C * attrs["shift_ratio"])
    c2 = int(C * 2 * attrs["shift_ratio"])
    v = v.reshape(NT // T, T, C, H, W)
    back = torch.cat([v[:, 1:, :c1], torch.zeros_like(v[:, :1, :c1])], 1)
    fwd = torch.cat([torch.zeros_like(v[:, :1, c1:c2]), v[:, :-1, c1:c2]],
                    1)
    return out(torch.cat([back, fwd, v[:, :, c2:]], 2).reshape(NT, C, H, W))


def _bilinear_taps(v, yy, xx):
    """Bilinear samples of v [N, C, H, W] at the real pixel coordinates
    yy, xx [N, Ho, Wo]: four taps, a tap outside the image 0 ->
    [N, C, Ho, Wo]."""
    N, C, H, W = v.shape
    y0, x0 = torch.floor(yy), torch.floor(xx)
    wy1, wx1 = yy - y0, xx - x0
    y0, x0 = y0.long(), x0.long()
    bidx = torch.arange(N, device=v.device)[:, None, None]

    def tap(yi, xi, wgt):
        inb = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        val = v[bidx, :, yi.clamp(0, H - 1), xi.clamp(0, W - 1)]
        return val.permute(0, 3, 1, 2) * (wgt * inb)[:, None]
    return (tap(y0, x0, (1 - wy1) * (1 - wx1))
            + tap(y0, x0 + 1, (1 - wy1) * wx1)
            + tap(y0 + 1, x0, wy1 * (1 - wx1))
            + tap(y0 + 1, x0 + 1, wy1 * wx1))


@register("grid_sampler", attrs={"mode": "bilinear",
                                 "padding_mode": "zeros",
                                 "align_corners": True})
def _grid_sampler(ctx, ins, attrs):
    """Bilinear grid sample: X [N,C,H,W] + Grid [N,Ho,Wo,2] in [-1,1] ->
    [N,C,Ho,Wo]; zero padding outside."""
    v = x(ins, "X").float()
    grid = x(ins, "Grid").float()
    N, C, H, W = v.shape
    if attrs.get("align_corners", True):
        gx = (grid[..., 0] + 1) * (W - 1) / 2
        gy = (grid[..., 1] + 1) * (H - 1) / 2
    else:
        gx = ((grid[..., 0] + 1) * W - 1) / 2
        gy = ((grid[..., 1] + 1) * H - 1) / 2
    return {"Output": [_bilinear_taps(v, gy, gx)]}


@register("affine_grid", no_grad_slots=("OutputShape",),
          attrs={"align_corners": True, "output_shape": []})
def _affine_grid(ctx, ins, attrs):
    """Theta [N,2,3] -> sampling grid [N,H,W,2]."""
    theta = x(ins, "Theta").float()
    shape_v = x(ins, "OutputShape")
    if shape_v is not None:
        _, _, H, W = [int(s) for s in shape_v.reshape(-1).tolist()]
    else:
        _, _, H, W = attrs["output_shape"]
    dev = theta.device
    if attrs.get("align_corners", True):
        ys = torch.linspace(-1, 1, H, device=dev)
        xs = torch.linspace(-1, 1, W, device=dev)
    else:
        ys = (torch.arange(H, device=dev) * 2 + 1) / H - 1
        xs = (torch.arange(W, device=dev) * 2 + 1) / W - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], -1)     # [H, W, 3]
    return {"Output": [torch.einsum("hwk,njk->nhwj", base, theta)]}


def _unfold_cols(v, kernel_sizes, strides, paddings, dilations):
    kh, kw = kernel_sizes
    sh, sw = strides
    p = paddings
    dh, dw = dilations
    v = F.pad(v, (p[1], p[3] if len(p) > 3 else p[1],
                  p[0], p[2] if len(p) > 2 else p[0]))
    N, C, H, W = v.shape
    oh = (H - (dh * (kh - 1) + 1)) // sh + 1
    ow = (W - (dw * (kw - 1) + 1)) // sw + 1
    cols = [v[:, :, i * dh:i * dh + oh * sh:sh,
              j * dw:j * dw + ow * sw:sw].reshape(N, C, -1)
            for i in range(kh) for j in range(kw)]
    return torch.stack(cols, 2).reshape(N, C * kh * kw, -1)


@register("unfold", attrs={"kernel_sizes": [3, 3], "strides": [1, 1],
                           "paddings": [0, 0, 0, 0], "dilations": [1, 1]})
def _unfold(ctx, ins, attrs):
    """im2col: [N,C,H,W] -> [N, C*kh*kw, L]."""
    return {"Y": [_unfold_cols(x(ins, "X"), attrs["kernel_sizes"],
                               attrs["strides"], attrs["paddings"],
                               attrs["dilations"])]}


@register("spp", attrs={"pyramid_height": 2, "pooling_type": "max"})
def _spp(ctx, ins, attrs):
    """Spatial pyramid pooling: adaptive pools at 1x1, 2x2, ...
    2^(h-1) bins, flattened and concatenated."""
    v = x(ins, "X")
    pool = require("pool2d").compute
    outs = []
    for lvl in range(attrs["pyramid_height"]):
        bins = 2 ** lvl
        r = pool(ctx, {"X": [v]},
                 {"pooling_type": attrs["pooling_type"],
                  "ksize": [bins, bins], "adaptive": True,
                  "global_pooling": False, "strides": [1, 1],
                  "paddings": [0, 0], "exclusive": True,
                  "ceil_mode": False, "data_format": "NCHW",
                  "padding_algorithm": "EXPLICIT"})["Out"][0]
        outs.append(r.reshape(v.shape[0], -1))
    return out(torch.cat(outs, 1))


@register("norm", no_grad_out_slots=("Norm",),
          attrs={"axis": 1, "epsilon": 1e-10})
def _norm(ctx, ins, attrs):
    """L2-normalise along axis; Norm carries the magnitudes."""
    v = x(ins, "X")
    nrm = torch.sqrt(torch.square(v).sum(attrs["axis"], keepdim=True)
                     + attrs["epsilon"])
    return {"Out": [v / nrm], "Norm": [nrm]}


# ---------------------------------------------------------------------------
# sequence extras
# ---------------------------------------------------------------------------

def _levenshtein(h, r):
    prev = list(range(len(h) + 1))
    for j, rj in enumerate(r):
        cur = [j + 1]
        for i, hi in enumerate(h):
            cur.append(min(prev[i + 1] + 1, cur[i] + 1,
                           prev[i] + (hi != rj)))
        prev = cur
    return prev[-1]


@register("edit_distance", grad=None,
          no_grad_slots=("Hyps", "Refs", "HypsLength", "RefsLength"),
          attrs={"normalized": False})
def _edit_distance(ctx, ins, attrs):
    """Levenshtein distance of each (hypothesis, reference) pair over
    their lengths (dense [B, L] + lengths), divided by the reference's
    length when normalized."""
    hyp, ref = x(ins, "Hyps"), x(ins, "Refs")
    B, HL = hyp.shape
    RL = ref.shape[1]
    hlen, rlen = x(ins, "HypsLength"), x(ins, "RefsLength")
    hl = [HL] * B if hlen is None else hlen.reshape(-1).tolist()
    rl = [RL] * B if rlen is None else rlen.reshape(-1).tolist()
    hs, rs = hyp.tolist(), ref.tolist()
    d = [float(_levenshtein(hs[b][:hl[b]], rs[b][:rl[b]]))
         for b in range(B)]
    if attrs["normalized"]:
        d = [v / max(float(rl[b]), 1.0) for b, v in enumerate(d)]
    return {"Out": [torch.tensor(d, dtype=torch.float32,
                                 device=hyp.device)[:, None]],
            "SequenceNum": [torch.tensor([B], dtype=torch.int64,
                                         device=hyp.device)]}


@register("ctc_align", grad=None, attrs={"blank": 0, "merge_repeated": True,
                                         "padding_value": 0})
def _ctc_align(ctx, ins, attrs):
    """CTC paths collapsed (repeats merged, then blanks dropped), left
    aligned and padded, with the lengths."""
    v = x(ins, "Input").int()
    B, T = v.shape
    prev = torch.cat([torch.full((B, 1), -1, dtype=v.dtype,
                                 device=v.device), v[:, :-1]], 1)
    keep = v != attrs["blank"]
    if attrs["merge_repeated"]:
        keep &= v != prev
    pos = torch.cumsum(keep.int(), 1) - 1
    res = torch.full((B, T), attrs["padding_value"], dtype=torch.int32,
                     device=v.device)
    rows = torch.arange(B, device=v.device)[:, None].expand(B, T)
    res[rows[keep], pos[keep].long()] = v[keep]
    return {"Output": [res],
            "OutputLength": [keep.int().sum(1, dtype=torch.int32)[:, None]]}


@register("im2sequence", grad=None,
          attrs={"kernels": [1, 1], "strides": [1, 1],
                 "paddings": [0, 0, 0, 0], "out_stride": [1, 1]})
def _im2sequence(ctx, ins, attrs):
    """Image -> patch rows: [N,C,H,W] -> [N*oh*ow, C*kh*kw]."""
    y = _unfold_cols(x(ins, "X"), attrs["kernels"], attrs["strides"],
                     attrs["paddings"], [1, 1])
    N, CK, L = y.shape
    return out(y.transpose(1, 2).reshape(N * L, CK))


@register("row_conv", attrs={})
def _row_conv(ctx, ins, attrs):
    """Lookahead row convolution (DeepSpeech2): Out[t] = sum_k X[t+k] W[k]
    over a [future_len, D] filter."""
    v, w = x(ins, "X"), x(ins, "Filter")
    K, T = w.shape[0], v.shape[1]
    pad = F.pad(v, (0, 0, 0, K - 1))
    return out(sum(pad[:, k:k + T] * w[k][None, None, :] for k in range(K)))


# ---------------------------------------------------------------------------
# rnn step units
# ---------------------------------------------------------------------------

@register("gru_unit", no_grad_out_slots=("ResetHiddenPrev", "Gate"),
          attrs={"activation": "tanh", "gate_activation": "sigmoid",
                 "origin_mode": False})
def _gru_unit(ctx, ins, attrs):
    """One GRU step: Input [B, 3D] (the projected x), HiddenPrev [B, D],
    Weight [D, 3D], Bias [1, 3D]; gates u|r then the candidate."""
    xin, h = x(ins, "Input"), x(ins, "HiddenPrev")
    w, b = x(ins, "Weight"), x(ins, "Bias")
    D = h.shape[1]
    gates_x = xin if b is None else xin + b.reshape(-1)
    ru = torch.sigmoid(gates_x[:, :2 * D] + h @ w[:, :2 * D])
    r, u = ru[:, :D], ru[:, D:]
    rh = r * h
    c = torch.tanh(gates_x[:, 2 * D:] + rh @ w[:, 2 * D:])
    new_h = u * h + (1 - u) * c if attrs.get("origin_mode") \
        else (1 - u) * h + u * c
    return {"Hidden": [new_h], "ResetHiddenPrev": [rh],
            "Gate": [torch.cat([ru, c], 1)]}


@register("lstm_unit", attrs={"forget_bias": 0.0})
def _lstm_unit(ctx, ins, attrs):
    """One LSTM step: X [B, 4D] pre-activations (i, f, c~, o), C_prev
    [B, D]."""
    xin, c_prev = x(ins, "X"), x(ins, "C_prev")
    D = c_prev.shape[1]
    i = torch.sigmoid(xin[:, :D])
    f = torch.sigmoid(xin[:, D:2 * D] + attrs["forget_bias"])
    g = torch.tanh(xin[:, 2 * D:3 * D])
    o = torch.sigmoid(xin[:, 3 * D:])
    c = f * c_prev + i * g
    return {"C": [c], "H": [o * torch.tanh(c)]}


@register("add_position_encoding", attrs={"alpha": 1.0, "beta": 1.0})
def _add_position_encoding(ctx, ins, attrs):
    """alpha * X + beta * the sinusoidal position encoding (sin on the
    even columns, cos on the odd)."""
    v = x(ins, "X")                                # [B, T, D]
    B, T, D = v.shape
    pos = torch.arange(T, dtype=torch.float32, device=v.device)[:, None]
    div = torch.exp(torch.arange(0, D, 2, dtype=torch.float32,
                                 device=v.device)
                    * (-math.log(10000.0) / D))
    pe = torch.zeros((T, D), dtype=torch.float32, device=v.device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div[:D // 2])
    return out(attrs["alpha"] * v + attrs["beta"] * pe[None])


# ---------------------------------------------------------------------------
# ranking / distillation losses
# ---------------------------------------------------------------------------

@register("margin_rank_loss", no_grad_slots=("Label",),
          no_grad_out_slots=("Activated",),
          attrs={"margin": 0.0})
def _margin_rank_loss(ctx, ins, attrs):
    lab = x(ins, "Label")
    a, b = x(ins, "X1"), x(ins, "X2")
    act = torch.clamp(-lab * (a - b) + attrs["margin"], min=0.0)
    return {"Out": [act], "Activated": [(act > 0).to(a.dtype)]}


@register("rank_loss", no_grad_slots=("Label",))
def _rank_loss(ctx, ins, attrs):
    """RankNet's pairwise loss."""
    lab = x(ins, "Label")
    d = x(ins, "Left") - x(ins, "Right")
    return out(F.softplus(d) - lab * d)


@register("teacher_student_sigmoid_loss", no_grad_slots=("Label",),
          attrs={"soft_max_up_bound": 15.0, "soft_max_lower_bound": -15.0})
def _ts_sigmoid_loss(ctx, ins, attrs):
    """CTR distillation: a label below 0 is the teacher's soft target
    -label; otherwise the hard sigmoid cross entropy."""
    z = x(ins, "X").reshape(-1)
    lab = x(ins, "Label").reshape(-1).float()
    sp = F.softplus(z)
    return out(torch.where(lab < 0, sp + lab * z, sp - lab * z)[:, None])


# ---------------------------------------------------------------------------
# optimizers / grad utils
# ---------------------------------------------------------------------------

def _lr_of(ins):
    return x(ins, "LearningRate").reshape(())


def _shrink(prox, l1, l2):
    return torch.sign(prox) * torch.clamp(torch.abs(prox) - l1, min=0.0) \
        / (1.0 + l2)


@register("proximal_gd", grad=None, attrs={"l1": 0.0, "l2": 0.0})
def _proximal_gd(ctx, ins, attrs):
    """Proximal gradient descent with L1 / L2 shrinkage."""
    p, g = x(ins, "Param"), x(ins, "Grad")
    lr = _lr_of(ins)
    return {"ParamOut": [_shrink(p - lr * g, lr * attrs["l1"],
                                 lr * attrs["l2"])]}


@register("proximal_adagrad", grad=None, attrs={"l1": 0.0, "l2": 0.0})
def _proximal_adagrad(ctx, ins, attrs):
    p, g, m = x(ins, "Param"), x(ins, "Grad"), x(ins, "Moment")
    m_new = m + g * g
    eff = _lr_of(ins) / torch.sqrt(m_new)
    return {"ParamOut": [_shrink(p - eff * g, eff * attrs["l1"],
                                 eff * attrs["l2"])],
            "MomentOut": [m_new]}


@register("dgc_clip_by_norm", attrs={"max_norm": 1.0, "rampup_begin_step":
                                     0.0})
def _dgc_clip_by_norm(ctx, ins, attrs):
    """clip_by_norm from DGC's rampup step on; the identity before."""
    v = x(ins, "X")
    step = x(ins, "current_step").reshape(())
    nrm = torch.sqrt(torch.square(v).sum())
    clipped = v * torch.clamp(attrs["max_norm"] / torch.clamp(nrm,
                                                              min=1e-12),
                              max=1.0)
    return out(torch.where(step < attrs["rampup_begin_step"], v, clipped))


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

@register("precision_recall", grad=None, attrs={"class_number": 2})
def _precision_recall(ctx, ins, attrs):
    """Macro and micro precision, recall and F1 of the predicted Indices
    against Labels: [macro P, R, F1, micro P, R, F1], and per-class
    [TP, FP, FN, TP + FN]."""
    idx = x(ins, "Indices").reshape(-1).long()
    lab = x(ins, "Labels").reshape(-1).long()
    C = attrs["class_number"]
    pred_oh = F.one_hot(idx, C).float()
    lab_oh = F.one_hot(lab, C).float()
    tp = (pred_oh * lab_oh).sum(0)
    fp = pred_oh.sum(0) - tp
    fn = lab_oh.sum(0) - tp

    def div(a, b):
        return a / torch.clamp(b, min=1e-12)
    prec, rec = div(tp, tp + fp), div(tp, tp + fn)
    f1 = div(2 * prec * rec, prec + rec)
    macro = torch.stack([prec.mean(), rec.mean(), f1.mean()])
    stp, sfp, sfn = tp.sum(), fp.sum(), fn.sum()
    mp, mr = div(stp, stp + sfp), div(stp, stp + sfn)
    micro = torch.stack([mp, mr, div(2 * mp * mr, mp + mr)])
    both = torch.cat([macro, micro])
    return {"BatchMetrics": [both], "AccumMetrics": [both.clone()],
            "AccumStatesInfo": [torch.stack([tp, fp, fn, tp + fn], 1)]}


@register("positive_negative_pair", grad=None, attrs={})
def _pos_neg_pair(ctx, ins, attrs):
    """Correctly ordered (positive), mis-ordered (negative) and tied
    (neutral) score pairs within each query."""
    score = x(ins, "Score").reshape(-1)
    lab = x(ins, "Label").reshape(-1).float()
    qid = x(ins, "QueryID").reshape(-1)
    pairs = (qid[:, None] == qid[None, :]) & (lab[:, None] > lab[None, :])
    s1, s2 = score[:, None], score[None, :]

    def count(m):
        return (pairs & m).sum().float().reshape(1, 1)
    return {"PositivePair": [count(s1 > s2)], "NegativePair": [count(s1 < s2)],
            "NeutralPair": [count(s1 == s2)]}


# ---------------------------------------------------------------------------
# detection extras / tensor extras / PS id ops
# ---------------------------------------------------------------------------

@register("anchor_generator", grad=None,
          attrs={"anchor_sizes": [64.0], "aspect_ratios": [1.0],
                 "variances": [0.1, 0.1, 0.2, 0.2], "stride": [16.0, 16.0],
                 "offset": 0.5})
def _anchor_generator(ctx, ins, attrs):
    """RPN anchors [H, W, A, 4] in input-image pixels, and their
    variances."""
    feat = x(ins, "Input")
    H, W = feat.shape[2], feat.shape[3]
    sw, sh = attrs["stride"]
    whs = []
    for size in attrs["anchor_sizes"]:
        area = float(size) ** 2
        for ar in attrs["aspect_ratios"]:
            w = math.sqrt(area / ar)
            whs.append((w, w * ar))
    whs = np.asarray(whs, np.float32)
    cx = (np.arange(W, dtype=np.float32) + attrs["offset"]) * sw
    cy = (np.arange(H, dtype=np.float32) + attrs["offset"]) * sh
    cxg, cyg = np.meshgrid(cx, cy)
    anchors = np.stack([
        cxg[:, :, None] - whs[None, None, :, 0] / 2,
        cyg[:, :, None] - whs[None, None, :, 1] / 2,
        cxg[:, :, None] + whs[None, None, :, 0] / 2,
        cyg[:, :, None] + whs[None, None, :, 1] / 2], axis=-1)
    var = np.broadcast_to(np.asarray(attrs["variances"], np.float32),
                          anchors.shape)
    return {"Anchors": [torch.as_tensor(anchors, device=feat.device)],
            "Variances": [torch.as_tensor(var.copy(), device=feat.device)]}


@register("histogram", grad=None, attrs={"bins": 100, "min": 0, "max": 0})
def _histogram(ctx, ins, attrs):
    """Counts over `bins` equal bins of [min, max] (the data's range when
    both are 0), the last bin closed; values outside are not counted."""
    v = x(ins, "X").reshape(-1).float()
    bins = attrs["bins"]
    lo, hi = float(attrs["min"]), float(attrs["max"])
    if lo == 0 and hi == 0:
        lo, hi = float(v.min()), float(v.max())
    edges = torch.linspace(lo, hi, bins + 1, device=v.device)
    idx = torch.searchsorted(edges, v, right=True)
    idx = torch.where(v == edges[-1], torch.full_like(idx, bins), idx)
    counts = torch.bincount(idx, minlength=bins + 2)
    return out(counts[1:bins + 1].long())


@register("masked_select", grad=None, no_grad_slots=("Mask",))
def _masked_select(ctx, ins, attrs):
    """The entries of X where Mask is true, flat (a data-dependent
    shape)."""
    return out(x(ins, "X")[x(ins, "Mask").bool()])


@register("split_ids", grad=None, attrs={})
def _split_ids(ctx, ins, attrs):
    """Ids routed to parameter-server shards by id % n (n the number of
    Out slots given, else num_shards)."""
    ids = x(ins, "Ids").reshape(-1)
    n = len(ins.get("Out") or []) or attrs.get("num_shards", 1)
    return {"Out": [ids[ids % n == s] for s in range(n)]}


@register("merge_ids", grad=None, attrs={})
def _merge_ids(ctx, ins, attrs):
    """split_ids' inverse: each shard's rows back in the original ids'
    order (rows [N, D] a shard, X the shard's ids)."""
    ids = x(ins, "Ids").reshape(-1)
    rows = ins.get("Rows", [])
    res = torch.zeros((ids.numel(), rows[0].shape[-1]), dtype=rows[0].dtype,
                      device=rows[0].device)
    for sid, r in zip(ins.get("X", []), rows):
        for i, v in enumerate(sid.reshape(-1).tolist()):
            res[ids == v] = r[i]
    return out(res)

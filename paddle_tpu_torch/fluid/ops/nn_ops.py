"""NN ops (counterpart of ``paddle_tpu/fluid/ops/nn_ops.py``, and of the
``fused_attention`` and ``paged_attention`` ops the reference registers
in ``ops/flash_attention.py`` and ``ops/paged_attention.py``), on torch
tensors.

conv2d, pool2d and batch_norm run the bodies that the eager functions of
``nn/functional.py`` run (``conv2d_op``, ``pool2d_op``,
``batch_norm_op``): PyTorch's own convolution and pooling, and the
reference's batch-norm arithmetic with its hand-derived backward; the
reference computes them outside any Pallas kernel
(``lax.conv_general_dilated``, ``lax.reduce_window``, jnp). The 3-D
convolutions and pooling, the transposed convolutions, the other norms
and the losses are PyTorch's functions or the reference's arithmetic.

Where the reference reaches a Pallas kernel the op reaches the port's
kernel wrapper through the function the eager layers call:

  layer_norm            ``F.layer_norm_op`` (ops/layer_norm.py, B rows 8-9)
  fused_dropout_add_ln  ``F.fused_dropout_add_ln`` (ops/fused_residual.py,
                        rows 6-7)
  fused_out_ln          ``F.fused_out_ln`` (ops/fused_block.py, row 2)
  fused_ffn_block       ``F.fused_ffn_block`` (ops/fused_block.py, row 3)
  fused_ffn             ``ops.fused_ffn`` (row 10), behind the reference's
                        gate
  fused_attention       ``ops.flash_attention`` (rows 4-5) where
                        ``can_use_flash`` admits the call, else
                        ``sdpa_reference``
  paged_attention       ``ops.paged_attention`` (row 1), inference only

A stochastic op's seed is ``ctx.rng(attrs)``: the same int32 in the
forward op and in its grad op, which re-runs the forward, so the masks
agree. In test mode (``ctx.is_test``) the dropout probabilities are 0.
The reference draws dropout masks from jax.random, which the port
cannot replay: the two packages agree at dropout 0 and in distribution.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ...nn import functional as pf
from ...nn.functional import (batch_norm_op, conv2d_op, pool2d_op,
                              softmax_with_cross_entropy)
from ...ops import flash_attention as _fa
from ...ops import fused_ffn as _ffn
from ...ops import paged_attention as _pa
from ..core import torch_dtype
from ..registry import register, require, same_shape_as
from ..selected_rows import SelectedRows
from .common import out, x


# ---------------------------------------------------------------------------
# convolution
# ---------------------------------------------------------------------------

def _conv2d_infer(op):
    iv, fv = op.invar("Input"), op.invar("Filter")
    if iv is None or iv.shape is None or fv is None or fv.shape is None:
        return
    s = op.attr("strides", [1, 1])
    p = op.attr("paddings", [0, 0])
    d = op.attr("dilations", [1, 1])
    algo = op.attr("padding_algorithm", "EXPLICIT")
    nhwc = op.attr("data_format", "NCHW") == "NHWC"
    if nhwc:
        n, h, w, _ = iv.shape
    else:
        n, _, h, w = iv.shape
    oc, _, kh, kw = fv.shape
    if algo == "SAME":
        oh = -(-h // s[0]) if h > 0 else h
        ow = -(-w // s[1]) if w > 0 else w
    else:
        if algo == "VALID":
            ph0 = ph1 = pw0 = pw1 = 0
        elif len(p) == 2:
            ph0 = ph1 = p[0]; pw0 = pw1 = p[1]
        else:
            ph0, ph1, pw0, pw1 = p
        ekh, ekw = (kh - 1) * d[0] + 1, (kw - 1) * d[1] + 1
        oh = (h + ph0 + ph1 - ekh) // s[0] + 1 if h > 0 else h
        ow = (w + pw0 + pw1 - ekw) // s[1] + 1 if w > 0 else w
    oshape = (n, oh, ow, oc) if nhwc else (n, oc, oh, ow)
    for name in op.output("Output"):
        op.block.create_var(name=name, shape=oshape, dtype=iv.dtype)


def _conv2d(ctx, ins, attrs):
    return {"Output": [conv2d_op(
        x(ins, "Input"), x(ins, "Filter"), attrs.get("strides", [1, 1]),
        attrs.get("paddings", [0, 0]), attrs.get("dilations", [1, 1]),
        attrs.get("groups", 1), attrs.get("padding_algorithm", "EXPLICIT"),
        attrs.get("data_format", "NCHW"))]}


_CONV_ATTRS = {"strides": [1, 1], "paddings": [0, 0], "dilations": [1, 1],
               "groups": 1, "padding_algorithm": "EXPLICIT",
               "data_format": "NCHW", "use_cudnn": False}
register("conv2d", _conv2d, infer_shape=_conv2d_infer,
         attrs=dict(_CONV_ATTRS))
register("depthwise_conv2d", _conv2d, infer_shape=_conv2d_infer,
         attrs=dict(_CONV_ATTRS))


def _transpose_pads(p, algo, k_eff, strides, nsp):
    """(lo, hi) crops of the full transposed-convolution output per
    spatial axis: Paddle's paddings ([p] per axis or [lo, hi] pairs),
    VALID (none) or SAME (out = in * stride)."""
    if algo == "VALID":
        return [(0, 0)] * nsp
    if algo == "SAME":
        return [((k_eff[i] - strides[i]) // 2,
                 k_eff[i] - strides[i] - (k_eff[i] - strides[i]) // 2)
                for i in range(nsp)]
    if len(p) == nsp:
        return [(q, q) for q in p]
    return [(p[2 * i], p[2 * i + 1]) for i in range(nsp)]


def _conv_transpose(ctx, ins, attrs, nsp):
    """out = (i-1)*s + k_eff - lo - hi + output_padding: PyTorch's
    transposed convolution without padding, cropped by (lo, hi); the
    filter is (in, out/groups, k...), PyTorch's layout too."""
    inp, flt = x(ins, "Input"), x(ins, "Filter")
    one = [1] * nsp
    strides = list(attrs.get("strides") or one)
    dil = list(attrs.get("dilations") or one)
    g = attrs.get("groups", 1) or 1
    out_pad = list(attrs.get("output_padding") or [0] * nsp)
    k_eff = [dil[i] * (flt.shape[2 + i] - 1) + 1 for i in range(nsp)]
    pads = _transpose_pads(list(attrs.get("paddings") or [0] * nsp),
                           attrs.get("padding_algorithm", "EXPLICIT"),
                           k_eff, strides, nsp)
    last = attrs.get("data_format", "NCHW") in ("NHWC", "NDHWC")
    if last:
        inp = inp.movedim(-1, 1)
    fn = F.conv_transpose2d if nsp == 2 else F.conv_transpose3d
    r = fn(inp, flt, stride=strides, dilation=dil, groups=g)
    full = r.shape[2:]
    extra = [max(o - hi, 0) for o, (_, hi) in zip(out_pad, pads)]
    if any(extra):
        pad = []
        for e in reversed(extra):
            pad += [0, e]
        r = F.pad(r, pad)
    idx = (slice(None), slice(None)) + tuple(
        slice(lo, full[i] - hi + out_pad[i]) for i, (lo, hi) in
        enumerate(pads))
    r = r[idx]
    return {"Output": [r.movedim(1, -1) if last else r]}


register("conv2d_transpose",
         lambda ctx, ins, attrs: _conv_transpose(ctx, ins, attrs, 2),
         attrs=dict(_CONV_ATTRS, output_padding=[], output_size=[]))


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------

def _pool2d_infer(op):
    v = op.invar("X")
    if v is None or v.shape is None:
        return
    nhwc = op.attr("data_format", "NCHW") == "NHWC"
    if nhwc:
        n, h, w, c = v.shape
    else:
        n, c, h, w = v.shape
    if op.attr("global_pooling", False) or op.attr("adaptive", False) and \
            list(op.attr("ksize", [1, 1])) == [1, 1]:
        oh = ow = 1
    elif op.attr("adaptive", False):
        oh, ow = op.attr("ksize")
    else:
        k = op.attr("ksize", [2, 2]); s = op.attr("strides", [2, 2])
        p = op.attr("paddings", [0, 0])
        if op.attr("ceil_mode", False):
            oh = -(-(h + 2 * p[0] - k[0]) // s[0]) + 1 if h > 0 else h
            ow = -(-(w + 2 * p[1] - k[1]) // s[1]) + 1 if w > 0 else w
        else:
            oh = (h + 2 * p[0] - k[0]) // s[0] + 1 if h > 0 else h
            ow = (w + 2 * p[1] - k[1]) // s[1] + 1 if w > 0 else w
    oshape = (n, oh, ow, c) if nhwc else (n, c, oh, ow)
    for name in op.output("Out"):
        op.block.create_var(name=name, shape=oshape, dtype=v.dtype)


@register("pool2d", infer_shape=_pool2d_infer,
          attrs={"pooling_type": "max", "ksize": [2, 2], "strides": [2, 2],
                 "paddings": [0, 0], "global_pooling": False,
                 "ceil_mode": False, "exclusive": True, "adaptive": False,
                 "data_format": "NCHW", "use_cudnn": False})
def _pool2d(ctx, ins, attrs):
    return out(pool2d_op(
        x(ins), attrs["pooling_type"], attrs["ksize"], attrs["strides"],
        attrs["paddings"], attrs.get("global_pooling", False),
        attrs.get("exclusive", True), attrs.get("adaptive", False),
        attrs.get("data_format", "NCHW")))


# ---------------------------------------------------------------------------
# batch norm
# ---------------------------------------------------------------------------

def _bn_infer(op):
    v = op.invar("X")
    if v is None:
        return
    for name in op.output("Y"):
        op.block.create_var(name=name, shape=v.shape, dtype=v.dtype)
    sv = op.invar("Scale")
    cshape = sv.shape if sv is not None else None
    for slot in ("MeanOut", "VarianceOut", "SavedMean", "SavedVariance"):
        for name in op.output(slot):
            op.block.create_var(name=name, shape=cshape, dtype="float32")


@register("batch_norm", infer_shape=_bn_infer,
          attrs={"momentum": 0.9, "epsilon": 1e-5, "is_test": False,
                 "data_layout": "NCHW", "use_global_stats": False,
                 "trainable_statistics": False},
          no_grad_out_slots=("MeanOut", "VarianceOut", "SavedMean",
                             "SavedVariance", "ReserveSpace"))
def _batch_norm(ctx, ins, attrs):
    is_test = attrs.get("is_test", False) or getattr(ctx, "is_test", False)
    y, mean_out, var_out, saved_mean, saved_inv = batch_norm_op(
        x(ins), x(ins, "Scale"), x(ins, "Bias"), x(ins, "Mean"),
        x(ins, "Variance"), attrs["momentum"], attrs["epsilon"],
        is_test or attrs.get("use_global_stats", False),
        attrs.get("data_layout", "NCHW"))
    return {"Y": [y], "MeanOut": [mean_out], "VarianceOut": [var_out],
            "SavedMean": [saved_mean], "SavedVariance": [saved_inv]}


# ---------------------------------------------------------------------------
# softmax with cross entropy
# ---------------------------------------------------------------------------

def _xent_infer(op):
    v = op.invar("X") or op.invar("Logits")
    if v is None or v.shape is None:
        return
    shape = tuple(list(v.shape[:-1]) + [1])
    for name in op.output("Y") + op.output("Loss"):
        op.block.create_var(name=name, shape=shape, dtype=v.dtype)
    for name in op.output("Softmax"):
        op.block.create_var(name=name, shape=v.shape, dtype=v.dtype)


@register("softmax_with_cross_entropy", infer_shape=_xent_infer,
          attrs={"soft_label": False, "ignore_index": -100, "axis": -1,
                 "numeric_stable_mode": True},
          no_grad_slots=("Label",), no_grad_out_slots=("Softmax",))
def _softmax_xent(ctx, ins, attrs):
    loss, sm = softmax_with_cross_entropy(
        x(ins, "Logits"), x(ins, "Label"), attrs.get("soft_label", False),
        attrs.get("ignore_index", -100), return_softmax=True,
        axis=attrs.get("axis", -1))
    return {"Loss": [loss], "Softmax": [sm]}


# ---------------------------------------------------------------------------
# fused transformer FFN: act(x@W1+b1)@W2+b2 in one op (B row 10,
# ops/fused_ffn.py over csrc/fused_ffn.cu, on the route ffn_route picks)
# ---------------------------------------------------------------------------

@register("fused_ffn", infer_shape=same_shape_as("X", "Out"),
          attrs={"activation": "gelu"})
def _fused_ffn_op(ctx, ins, attrs):
    v = x(ins, "X")
    w1, b1 = x(ins, "W1"), x(ins, "B1")
    w2, b2 = x(ins, "W2"), x(ins, "B2")
    act = attrs.get("activation", "gelu")
    h = v.shape[-1]
    i = w1.shape[1]
    m = math.prod(v.shape[:-1])
    if act in ("gelu", "relu") and _ffn.can_use_fused_ffn(
            m, h, i, itemsize=v.element_size()) \
            and _ffn.ffn_wins(m, h, i, v.dtype, act):
        return out(_ffn.fused_ffn(v, w1, b1, w2, b2, act))
    # composed fallback (non-aligned dims / kernels disabled / other act)
    hid = v.reshape(m, h) @ w1 + b1
    if act == "gelu":
        hid = F.gelu(hid.float()).to(v.dtype)
    else:
        hid = require(act).compute(ctx, {"X": [hid]}, {})["Out"][0]
    return out((hid @ w2 + b2).to(v.dtype).reshape(v.shape))


# ---------------------------------------------------------------------------
# layer / instance / group norm
# ---------------------------------------------------------------------------

def _ln_infer(op):
    v = op.invar("X")
    if v is None:
        return
    for name in op.output("Y"):
        op.block.create_var(name=name, shape=v.shape, dtype=v.dtype)
    if v.shape is not None:
        lead = v.shape[:op.attr("begin_norm_axis", 1)]
        rows = math.prod(lead) if all(s >= 0 for s in lead) else -1
        for slot in ("Mean", "Variance"):
            for name in op.output(slot):
                op.block.create_var(name=name, shape=(rows,),
                                    dtype="float32")


@register("layer_norm", infer_shape=_ln_infer,
          attrs={"epsilon": 1e-5, "begin_norm_axis": 1},
          no_grad_out_slots=("Mean", "Variance"))
def _layer_norm(ctx, ins, attrs):
    y, mean, var = pf.layer_norm_op(
        x(ins), x(ins, "Scale"), x(ins, "Bias"), attrs["epsilon"],
        attrs.get("begin_norm_axis", 1))
    return {"Y": [y], "Mean": [mean], "Variance": [var]}


def _norm_affine(y, scale, bias, cshape):
    if scale is not None:
        y = y * scale.reshape(cshape)
    if bias is not None:
        y = y + bias.reshape(cshape)
    return y


@register("instance_norm", attrs={"epsilon": 1e-5},
          no_grad_out_slots=("SavedMean", "SavedVariance"))
def _instance_norm(ctx, ins, attrs):
    v = x(ins)
    axes = tuple(range(2, v.dim()))
    mean = v.mean(axes, keepdim=True)
    var = v.var(axes, keepdim=True, unbiased=False)
    y = (v - mean) * torch.rsqrt(var + attrs["epsilon"])
    y = _norm_affine(y, x(ins, "Scale"), x(ins, "Bias"),
                     (1, -1) + (1,) * (v.dim() - 2))
    return {"Y": [y], "SavedMean": [mean.reshape(-1)],
            "SavedVariance": [var.reshape(-1)]}


@register("group_norm", attrs={"epsilon": 1e-5, "groups": 1,
                               "data_layout": "NCHW"},
          no_grad_out_slots=("Mean", "Variance"))
def _group_norm(ctx, ins, attrs):
    v = x(ins)
    g = attrs["groups"]
    n, c = v.shape[0], v.shape[1]
    r = v.reshape((n, g, c // g) + tuple(v.shape[2:]))
    axes = tuple(range(2, r.dim()))
    mean = r.mean(axes, keepdim=True)
    var = r.var(axes, keepdim=True, unbiased=False)
    y = ((r - mean) * torch.rsqrt(var + attrs["epsilon"])).reshape(v.shape)
    y = _norm_affine(y, x(ins, "Scale"), x(ins, "Bias"),
                     (1, c) + (1,) * (v.dim() - 2))
    return {"Y": [y], "Mean": [mean.reshape(n, g)],
            "Variance": [var.reshape(n, g)]}


# ---------------------------------------------------------------------------
# softmax and the losses
# ---------------------------------------------------------------------------

register("softmax", lambda ctx, ins, attrs: out(
    torch.softmax(x(ins), attrs["axis"])),
    infer_shape=same_shape_as("X"), attrs={"axis": -1, "use_cudnn": False})
register("log_softmax", lambda ctx, ins, attrs: out(
    torch.log_softmax(x(ins), attrs["axis"])),
    infer_shape=same_shape_as("X"), attrs={"axis": -1})


def _picked(logp, label, ignore_index, axis=-1):
    """-logp at the hard labels (label (..., 1) or (...)), 0 where the
    label is ignore_index."""
    lab = label.reshape(label.shape[:-1]) if label.shape[-1] == 1 \
        else label
    lab = lab.long().unsqueeze(axis)
    ignored = lab == ignore_index
    loss = -torch.gather(logp, axis, torch.where(ignored,
                                                 torch.zeros_like(lab), lab))
    return torch.where(ignored, torch.zeros_like(loss), loss)


@register("cross_entropy", infer_shape=_xent_infer,
          attrs={"soft_label": False, "ignore_index": -100},
          no_grad_slots=("Label",))
def _cross_entropy(ctx, ins, attrs):
    probs, label = x(ins, "X"), x(ins, "Label")
    logp = torch.log(torch.clamp(probs, min=1e-20))
    if attrs.get("soft_label"):
        return {"Y": [-(label * logp).sum(-1, keepdim=True)]}
    return {"Y": [_picked(logp, label, attrs.get("ignore_index", -100))]}


@register("mse_loss", infer_shape=same_shape_as("X"))
def _mse(ctx, ins, attrs):
    return out(torch.square(x(ins, "X") - x(ins, "Y")))


@register("bce_loss", infer_shape=same_shape_as("X"),
          no_grad_slots=("Label",))
def _bce(ctx, ins, attrs):
    p, lab = x(ins, "X"), x(ins, "Label")
    p = torch.clamp(p, 1e-12, 1 - 1e-12)
    return out(-(lab * torch.log(p) + (1 - lab) * torch.log1p(-p)))


@register("sigmoid_cross_entropy_with_logits",
          infer_shape=same_shape_as("X"),
          attrs={"ignore_index": -100, "normalize": False},
          no_grad_slots=("Label",))
def _sce_logits(ctx, ins, attrs):
    z, lab = x(ins, "X"), x(ins, "Label")
    loss = torch.clamp(z, min=0) - z * lab + torch.log1p(
        torch.exp(-torch.abs(z)))
    kept = lab != attrs.get("ignore_index", -100)
    loss = torch.where(kept, loss, torch.zeros_like(loss))
    if attrs.get("normalize"):
        loss = loss / torch.clamp(kept.to(loss.dtype).sum(), min=1.0)
    return out(loss)


@register("huber_loss", attrs={"delta": 1.0}, no_grad_slots=("Y",),
          infer_shape=same_shape_as("X", "Out"),
          no_grad_out_slots=("Residual",))
def _huber(ctx, ins, attrs):
    d = attrs["delta"]
    r = x(ins, "Y") - x(ins, "X")
    a = torch.abs(r)
    loss = torch.where(a <= d, 0.5 * r * r, d * (a - 0.5 * d))
    return {"Out": [loss], "Residual": [r]}


def _reduced(loss, red, denom=None):
    if red == "mean":
        return (loss.sum() / denom if denom is not None
                else loss.mean()).reshape(1)
    if red == "sum":
        return loss.sum().reshape(1)
    if red == "batchmean":
        return (loss.sum() / loss.shape[0]).reshape(1)
    return loss


@register("kldiv_loss", attrs={"reduction": "mean"},
          no_grad_slots=("Target",))
def _kldiv(ctx, ins, attrs):
    logp, target = x(ins, "X"), x(ins, "Target")
    loss = target * (torch.log(torch.clamp(target, min=1e-20)) - logp)
    return out(_reduced(loss, attrs.get("reduction", "mean")))


@register("nll_loss", attrs={"reduction": "mean", "ignore_index": -100},
          no_grad_slots=("Label",), no_grad_out_slots=("Total_weight",))
def _nll(ctx, ins, attrs):
    logp, lab = x(ins, "X"), x(ins, "Label").long()
    w = x(ins, "Weight")
    picked = torch.gather(logp, 1, lab[:, None])[:, 0]
    wt = w[lab] if w is not None else torch.ones_like(picked)
    loss = -picked * wt
    tot = wt.sum()
    red = attrs.get("reduction", "mean")
    return {"Out": [_reduced(loss, red, tot if red == "mean" else None)],
            "Total_weight": [tot.reshape(1)]}


@register("smooth_l1_loss", no_grad_slots=("Y",),
          no_grad_out_slots=("Diff",), attrs={"sigma": 1.0})
def _smooth_l1(ctx, ins, attrs):
    sigma2 = attrs["sigma"] ** 2
    d = x(ins, "X") - x(ins, "Y")
    a = torch.abs(d)
    loss = torch.where(a < 1.0 / sigma2, 0.5 * d * d * sigma2,
                       a - 0.5 / sigma2)
    return {"Out": [loss.sum(tuple(range(1, loss.dim())))[..., None]],
            "Diff": [d]}


@register("squared_error_cost", infer_shape=same_shape_as("X"),
          no_grad_slots=("Y",))
def _squared_error(ctx, ins, attrs):
    return out(torch.square(x(ins, "X") - x(ins, "Y")))


# ---------------------------------------------------------------------------
# dropout: the mask drawn from ctx.generator, replayed by the grad op
# ---------------------------------------------------------------------------

@register("dropout", infer_shape=same_shape_as("X"), stochastic=True,
          attrs={"dropout_prob": 0.5, "is_test": False, "fix_seed": False,
                 "seed": 0, "dropout_implementation": "downgrade_in_infer"},
          no_grad_out_slots=("Mask",))
def _dropout(ctx, ins, attrs):
    v = x(ins)
    p = attrs["dropout_prob"]
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if attrs.get("is_test", False) or ctx.is_test:
        return {"Out": [v * (1.0 - p) if impl == "downgrade_in_infer"
                        else v], "Mask": [None]}
    if p >= 1.0:
        return {"Out": [torch.zeros_like(v)], "Mask": [torch.zeros_like(v)]}
    keep = torch.rand(v.shape, generator=ctx.generator(attrs),
                      device=v.device) >= p
    kept = v / (1.0 - p) if impl == "upscale_in_train" else v
    return {"Out": [torch.where(keep, kept, torch.zeros_like(v))],
            "Mask": [keep.to(torch.uint8)]}


# ---------------------------------------------------------------------------
# embedding, with the dense gradient as its own op
# ---------------------------------------------------------------------------

def _embed_infer(op):
    ids, w = op.invar("Ids"), op.invar("W")
    if ids is None or w is None or ids.shape is None or w.shape is None:
        return
    idshape = ids.shape
    if op.type == "lookup_table" and idshape and idshape[-1] == 1:
        idshape = idshape[:-1]
    for name in op.output("Out"):
        op.block.create_var(name=name, shape=tuple(idshape) + (w.shape[-1],),
                            dtype=w.dtype)


def _ids(ids, squeeze_last):
    if squeeze_last and ids.dim() and ids.shape[-1] == 1:
        ids = ids.reshape(ids.shape[:-1])
    return ids.long()


def _lookup(ctx, ins, attrs, squeeze_last):
    ids, w = _ids(x(ins, "Ids"), squeeze_last), x(ins, "W")
    r = F.embedding(ids, w)
    pad = attrs.get("padding_idx", -1)
    if pad is not None and pad != -1:
        r = torch.where((ids == pad)[..., None], torch.zeros_like(r), r)
    return out(r)


def _lookup_grad(ctx, ins, attrs, squeeze_last):
    """W@GRAD: Out@GRAD's rows as a SelectedRows when is_sparse (one row
    an id, duplicates kept), else their dense scatter-add."""
    ids, w = _ids(x(ins, "Ids"), squeeze_last), x(ins, "W")
    og = x(ins, "Out@GRAD")
    rows = ids.reshape(-1)
    vals = og.reshape(-1, og.shape[-1]).float()
    pad = attrs.get("padding_idx", -1)
    if pad is not None and pad != -1:
        vals = torch.where((rows == pad)[:, None], torch.zeros_like(vals),
                           vals)
    if attrs.get("is_sparse"):
        return {"W@GRAD": [SelectedRows(rows, vals, w.shape[0])]}
    dense = torch.zeros(w.shape, dtype=vals.dtype, device=w.device)
    return {"W@GRAD": [dense.index_add_(0, rows, vals).to(w.dtype)]}


_EMB_ATTRS = {"padding_idx": -1, "is_sparse": False, "is_distributed": False}
for _name, _sq in (("lookup_table_v2", False), ("lookup_table", True)):
    register(_name, (lambda s: lambda ctx, ins, attrs: _lookup(
        ctx, ins, attrs, s))(_sq), infer_shape=_embed_infer,
        no_grad_slots=("Ids",), attrs=dict(_EMB_ATTRS))
    register(_name + "_grad", (lambda s: lambda ctx, ins, attrs:
                               _lookup_grad(ctx, ins, attrs, s))(_sq),
             grad=None, no_grad_slots=("Ids", "W", "Out@GRAD"))


def _one_hot_infer(op):
    v = op.invar("X")
    if v is None or v.shape is None:
        return
    for n in op.output("Out"):
        op.block.create_var(name=n, shape=tuple(v.shape)
                            + (op.attr("depth", -1),),
                            dtype=op.attr("dtype", "float32"))


def _one_hot(ctx, ins, attrs):
    """Out-of-range ids give all-zero rows, as jax.nn.one_hot's do."""
    ids = x(ins).long()
    depth = attrs["depth"]
    cls = torch.arange(depth, device=ids.device)
    return out((ids[..., None] == cls).to(
        torch_dtype(attrs.get("dtype", "float32"))))


for _name in ("one_hot_v2", "one_hot"):
    register(_name, _one_hot, grad=None, infer_shape=_one_hot_infer,
             attrs={"depth": -1, "dtype": "float32",
                    "allow_out_of_range": False})


# ---------------------------------------------------------------------------
# misc nn
# ---------------------------------------------------------------------------

@register("label_smooth", attrs={"epsilon": 0.1})
def _label_smooth(ctx, ins, attrs):
    lab, prior = x(ins), x(ins, "PriorDist")
    eps = attrs["epsilon"]
    if prior is None:
        return out((1 - eps) * lab + eps / lab.shape[-1])
    return out((1 - eps) * lab + eps * prior)


def _pad_infer(op):
    v = op.invar("X")
    if v is None or v.shape is None:
        return
    p = op.attr("paddings", [])
    shape = [s + p[2 * i] + p[2 * i + 1] if s >= 0 else s
             for i, s in enumerate(v.shape)]
    for n in op.output("Out"):
        op.block.create_var(name=n, shape=tuple(shape), dtype=v.dtype)


@register("pad", attrs={"paddings": [], "pad_value": 0.0},
          infer_shape=_pad_infer)
def _pad(ctx, ins, attrs):
    v, p = x(ins), attrs["paddings"]
    cfg = []
    for i in reversed(range(v.dim())):
        cfg += [p[2 * i], p[2 * i + 1]]
    return out(F.pad(v, cfg, value=attrs.get("pad_value", 0.0)))


@register("pad2d", attrs={"paddings": [0, 0, 0, 0], "mode": "constant",
                          "pad_value": 0.0, "data_format": "NCHW"})
def _pad2d(ctx, ins, attrs):
    v, p = x(ins), attrs["paddings"]
    cfg = [p[2], p[3], p[0], p[1]]
    mode = attrs.get("mode", "constant")
    if mode == "constant":
        return out(F.pad(v, cfg, value=attrs.get("pad_value", 0.0)))
    return out(F.pad(v, cfg, mode={"reflect": "reflect",
                                   "edge": "replicate"}[mode]))


@register("interp_nearest",
          attrs={"out_h": -1, "out_w": -1, "scale": 0.0,
                 "data_layout": "NCHW", "align_corners": False})
def _interp_nearest(ctx, ins, attrs):
    """Nearest neighbour at half-pixel centres, as jax.image.resize."""
    v = x(ins)
    oh, ow = attrs["out_h"], attrs["out_w"]
    if oh <= 0:
        oh = int(v.shape[2] * attrs["scale"])
        ow = int(v.shape[3] * attrs["scale"])
    return out(F.interpolate(v, size=(oh, ow), mode="nearest-exact"))


# ---------------------------------------------------------------------------
# quantisation simulation, with the straight-through gradient
# ---------------------------------------------------------------------------

def _fq_scale(ins, attrs, v):
    """The InScale tensor, else the scale attr, else the batch abs-max."""
    in_scale = x(ins, "InScale")
    if in_scale is not None:
        return in_scale.reshape(())
    scale = attrs.get("scale", 0.0)
    if scale:
        return torch.tensor(scale, dtype=torch.float32, device=v.device)
    return torch.clamp(torch.abs(v).max(), min=1e-8)


def _fake_quant_dequant(ctx, ins, attrs):
    v = x(ins)
    qmax = float(2 ** (attrs.get("bit_length", 8) - 1) - 1)
    scale = _fq_scale(ins, attrs, v)
    q = torch.clamp(torch.round(v / scale * qmax), -qmax, qmax)
    return {"Out": [(q * scale / qmax).to(v.dtype)],
            "OutScale": [scale.reshape(1)]}


def _fake_quant_grad(ctx, ins, attrs):
    v, og = x(ins, "X"), x(ins, "Out@GRAD")
    scale = _fq_scale(ins, attrs, v)
    return {"X@GRAD": [torch.where(torch.abs(v) <= scale, og,
                                   torch.zeros_like(og))]}


for _fq_name in ("fake_quantize_dequantize_abs_max",
                 "fake_quantize_dequantize_moving_average_abs_max"):
    register(_fq_name, _fake_quant_dequant,
             infer_shape=same_shape_as("X"),
             no_grad_slots=("InScale",), no_grad_out_slots=("OutScale",),
             attrs={"scale": 0.0, "bit_length": 8, "moving_rate": 0.9})
    register(_fq_name + "_grad", _fake_quant_grad, grad=None,
             no_grad_slots=("X", "InScale", "Out@GRAD"))


# ---------------------------------------------------------------------------
# mixture-of-experts FFN over parallel/moe.py
# ---------------------------------------------------------------------------

def _moe_infer(op):
    v = op.invar("X")
    if v is not None:
        for name in op.output("Out"):
            op.block.create_var(name=name, shape=v.shape, dtype=v.dtype)
    for name in op.output("AuxLoss"):
        op.block.create_var(name=name, shape=(1,), dtype="float32")


@register("moe_ffn", infer_shape=_moe_infer,
          attrs={"top_k": 1, "capacity_factor": 1.25})
def _moe_ffn(ctx, ins, attrs):
    from ...parallel.moe import moe_ffn
    y, aux = moe_ffn(
        x(ins, "X"), x(ins, "Gate"), x(ins, "WUp"), x(ins, "BUp"),
        x(ins, "WDown"), x(ins, "BDown"),
        capacity_factor=attrs["capacity_factor"], top_k=attrs["top_k"])
    return {"Out": [y], "AuxLoss": [aux.reshape(1)]}


# ---------------------------------------------------------------------------
# 3-D convolution and pooling (NCDHW)
# ---------------------------------------------------------------------------

def _conv3d_infer(op):
    iv, fv = op.invar("Input"), op.invar("Filter")
    if iv is None or iv.shape is None or fv is None or fv.shape is None:
        return
    s = op.attr("strides", [1, 1, 1])
    p = op.attr("paddings", [0, 0, 0])
    d = op.attr("dilations", [1, 1, 1])
    sp = []
    for i, (x_, k_) in enumerate(zip(iv.shape[2:], fv.shape[2:])):
        ek = (k_ - 1) * d[i] + 1
        sp.append((x_ + 2 * p[i] - ek) // s[i] + 1 if x_ > 0 else x_)
    for name in op.output("Output"):
        op.block.create_var(name=name, shape=(iv.shape[0], fv.shape[0], *sp),
                            dtype=iv.dtype)


def _same_pads(size, k, s, d):
    """(lo, hi) of XLA's SAME padding for one axis."""
    k_eff = (k - 1) * d + 1
    total = max((-(-size // s) - 1) * s + k_eff - size, 0)
    return total // 2, total - total // 2


_CONV3D_ATTRS = {"strides": [1, 1, 1], "paddings": [0, 0, 0],
                 "dilations": [1, 1, 1], "groups": 1,
                 "padding_algorithm": "EXPLICIT", "data_format": "NCDHW",
                 "use_cudnn": False}


@register("conv3d", infer_shape=_conv3d_infer, attrs=dict(_CONV3D_ATTRS))
def _conv3d(ctx, ins, attrs):
    inp, flt = x(ins, "Input"), x(ins, "Filter")
    s = list(attrs.get("strides", [1, 1, 1]))
    d = list(attrs.get("dilations", [1, 1, 1]))
    algo = attrs.get("padding_algorithm", "EXPLICIT")
    if algo == "SAME":
        pads = [_same_pads(inp.shape[2 + i], flt.shape[2 + i], s[i], d[i])
                for i in range(3)]
    elif algo == "VALID":
        pads = [(0, 0)] * 3
    else:
        pads = [(q, q) for q in attrs.get("paddings", [0, 0, 0])]
    cfg = []
    for lo, hi in reversed(pads):
        cfg += [lo, hi]
    return {"Output": [F.conv3d(F.pad(inp, cfg), flt, stride=s, dilation=d,
                                groups=attrs.get("groups", 1) or 1)]}


register("conv3d_transpose",
         lambda ctx, ins, attrs: _conv_transpose(ctx, ins, attrs, 3),
         attrs=dict(_CONV3D_ATTRS, output_padding=[], output_size=[]))


def _pool3d_infer(op):
    v = op.invar("X")
    if v is None or v.shape is None:
        return
    if op.attr("global_pooling", False):
        sp = [1, 1, 1]
    else:
        k = op.attr("ksize", [2, 2, 2])
        s = op.attr("strides", [2, 2, 2])
        p = op.attr("paddings", [0, 0, 0])
        sp = [(v.shape[2 + i] + 2 * p[i] - k[i]) // s[i] + 1
              if v.shape[2 + i] > 0 else v.shape[2 + i] for i in range(3)]
    for name in op.output("Out"):
        op.block.create_var(name=name, shape=(*v.shape[:2], *sp),
                            dtype=v.dtype)


@register("pool3d", infer_shape=_pool3d_infer,
          attrs={"pooling_type": "max", "ksize": [2, 2, 2],
                 "strides": [2, 2, 2], "paddings": [0, 0, 0],
                 "global_pooling": False, "ceil_mode": False,
                 "exclusive": True, "adaptive": False,
                 "data_format": "NCDHW", "use_cudnn": False})
def _pool3d(ctx, ins, attrs):
    v = x(ins)
    ptype = attrs["pooling_type"]
    if attrs.get("global_pooling") or (attrs.get("adaptive") and
                                       list(attrs["ksize"]) == [1, 1, 1]):
        return out(v.amax((2, 3, 4), keepdim=True) if ptype == "max"
                   else v.mean((2, 3, 4), keepdim=True))
    k, s, p = (list(attrs["ksize"]), list(attrs["strides"]),
               list(attrs["paddings"]))
    if ptype == "max":
        return out(F.max_pool3d(v, k, s, p))
    return out(F.avg_pool3d(
        v, k, s, p,
        count_include_pad=not (attrs.get("exclusive", True) and any(p))))


# ---------------------------------------------------------------------------
# the fused transformer sub-layer ops (B rows 2, 3, 6-7)
# ---------------------------------------------------------------------------

def _p_seed(ctx, attrs):
    """(dropout probability, int32 seed) of a fused op in this run."""
    p = 0.0 if ctx.is_test else float(attrs["dropout_p"])
    return p, (ctx.rng(attrs) if p > 0.0 else 0)


@register("fused_dropout_add_ln", infer_shape=same_shape_as("X", "Out"),
          stochastic=True, attrs={"dropout_p": 0.0, "epsilon": 1e-5})
def _fused_dropout_add_ln(ctx, ins, attrs):
    p, seed = _p_seed(ctx, attrs)
    return out(pf.fused_dropout_add_ln(
        x(ins, "X"), x(ins, "Residual"), x(ins, "Scale"), x(ins, "Bias"),
        dropout_p=p, epsilon=attrs["epsilon"], seed=seed))


@register("fused_out_ln", infer_shape=same_shape_as("Residual"),
          stochastic=True, attrs={"epsilon": 1e-5, "dropout_p": 0.0})
def _fused_out_ln_op(ctx, ins, attrs):
    """Out = LN(Residual + dropout(X @ W + B)) * Scale + Bias."""
    p, seed = _p_seed(ctx, attrs)
    return out(pf.fused_out_ln(
        x(ins, "X"), x(ins, "W"), x(ins, "B"), x(ins, "Residual"),
        x(ins, "Scale"), x(ins, "Bias"), dropout_p=p,
        epsilon=attrs["epsilon"], seed=seed))


@register("fused_ffn_block", infer_shape=same_shape_as("Residual"),
          stochastic=True,
          attrs={"activation": "gelu", "epsilon": 1e-5, "dropout_p": 0.0,
                 "norm": "post"})
def _fused_ffn_block_op(ctx, ins, attrs):
    """Out = [LN](Residual + dropout(act(X' @ W1 + B1) @ W2 + B2)), X'
    = LN(X) for norm "pre"."""
    p, seed = _p_seed(ctx, attrs)
    return out(pf.fused_ffn_block(
        x(ins, "X"), x(ins, "W1"), x(ins, "B1"), x(ins, "W2"), x(ins, "B2"),
        x(ins, "Residual"), x(ins, "Scale"), x(ins, "Bias"),
        activation=attrs.get("activation", "gelu"),
        norm=attrs.get("norm", "post"), dropout_p=p,
        epsilon=attrs["epsilon"], seed=seed))


# ---------------------------------------------------------------------------
# attention (B rows 4-5) and paged decode attention (row 1)
# ---------------------------------------------------------------------------

@register("fused_attention", stochastic=True,
          infer_shape=same_shape_as("Q"),
          attrs={"causal": False, "dropout_p": 0.0, "scale": 0.0},
          no_grad_slots=("Mask",))
def _fused_attention(ctx, ins, attrs):
    q, k, v = x(ins, "Q"), x(ins, "K"), x(ins, "V")
    mask = x(ins, "Mask")
    scale = attrs.get("scale") or None
    causal = attrs.get("causal", False)
    p = 0.0 if ctx.is_test else float(attrs.get("dropout_p", 0.0))
    seed = ctx.rng(attrs) if p > 0.0 else 0
    if _fa.can_use_flash(q, k, v, mask, p):
        return {"Out": [_fa.flash_attention(q, k, v, mask, scale, causal, p,
                                            seed)]}
    return {"Out": [_fa.sdpa_reference(q, k, v, mask, scale, causal, p,
                                       seed)]}


@register("paged_attention", grad=None, infer_shape=same_shape_as("Q"),
          attrs={"scale": 0.0, "impl": ""},
          no_grad_slots=("PageTable", "CtxLens"))
def _paged_attention_op(ctx, ins, attrs):
    """The decode step as a graph op (inference only). The reference's
    `impl` picks its XLA or Pallas body; the port has one per device."""
    return {"Out": [_pa.paged_attention_decode(
        x(ins, "Q"), x(ins, "KCache"), x(ins, "VCache"),
        x(ins, "PageTable"), x(ins, "CtxLens"),
        scale=attrs.get("scale") or None)]}

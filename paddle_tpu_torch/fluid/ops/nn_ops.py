"""NN ops (counterpart of ``paddle_tpu/fluid/ops/nn_ops.py``): conv2d,
pool2d, batch_norm, softmax_with_cross_entropy and fused_ffn, on torch
tensors.

conv2d, pool2d and batch_norm run the bodies that the eager functions of
``nn/functional.py`` run (``conv2d_op``, ``pool2d_op``,
``batch_norm_op``): PyTorch's own convolution and pooling, and the
reference's batch-norm arithmetic with its hand-derived backward; the
reference computes them outside any Pallas kernel
(``lax.conv_general_dilated``, ``lax.reduce_window``, jnp).
fused_ffn reaches the port's kernel wrapper ``ops.fused_ffn`` where the
reference reaches its Pallas kernel (``ops/pallas_ffn.py``), behind the
same gate.
"""
from __future__ import annotations

import math

import torch.nn.functional as F

from ...nn.functional import (batch_norm_op, conv2d_op, pool2d_op,
                              softmax_with_cross_entropy)
from ...ops import fused_ffn as _ffn
from ..registry import register, require, same_shape_as
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


register("conv2d", _conv2d, infer_shape=_conv2d_infer,
         attrs={"strides": [1, 1], "paddings": [0, 0], "dilations": [1, 1],
                "groups": 1, "padding_algorithm": "EXPLICIT",
                "data_format": "NCHW", "use_cudnn": False})


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

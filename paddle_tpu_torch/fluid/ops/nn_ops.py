"""NN ops (counterpart of ``paddle_tpu/fluid/ops/nn_ops.py``): conv2d,
pool2d, softmax_with_cross_entropy and fused_ffn, on torch tensors.

conv2d and pool2d are PyTorch's own (``F.conv2d``, ``F.max_pool2d``,
``F.avg_pool2d``): the reference computes them outside any Pallas kernel
(``lax.conv_general_dilated``, ``lax.reduce_window``). fused_ffn reaches
the port's kernel wrapper ``ops.fused_ffn`` where the reference reaches
its Pallas kernel (``ops/pallas_ffn.py``), behind the same gate.
"""
from __future__ import annotations

import math

import torch.nn.functional as F

from ...nn.functional import softmax_with_cross_entropy
from ...ops import fused_ffn as _ffn
from ..registry import register, require, same_shape_as
from .common import out, x


# ---------------------------------------------------------------------------
# convolution
# ---------------------------------------------------------------------------

def _conv_pad(paddings, algorithm, ksize, dilations):
    if algorithm == "SAME":
        return "SAME"
    if algorithm == "VALID":
        return "VALID"
    if len(paddings) == 2:
        return [(paddings[0], paddings[0]), (paddings[1], paddings[1])]
    if len(paddings) == 4:
        return [(paddings[0], paddings[1]), (paddings[2], paddings[3])]
    raise ValueError(f"bad paddings {paddings}")


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


def _same_pads(size, k, s, d):
    """XLA's SAME padding of one spatial axis: (low, high)."""
    o = -(-size // s)
    total = max((o - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def _conv2d(ctx, ins, attrs):
    inp, flt = x(ins, "Input"), x(ins, "Filter")
    strides = list(attrs.get("strides", [1, 1]))
    dilations = list(attrs.get("dilations", [1, 1]))
    pad = _conv_pad(attrs.get("paddings", [0, 0]),
                    attrs.get("padding_algorithm", "EXPLICIT"),
                    flt.shape[2:], dilations)
    nhwc = attrs.get("data_format", "NCHW") == "NHWC"
    if nhwc:
        inp = inp.permute(0, 3, 1, 2)
    if pad == "VALID":
        pad = [(0, 0), (0, 0)]
    elif pad == "SAME":
        pad = [_same_pads(inp.shape[2 + i], flt.shape[2 + i], strides[i],
                          dilations[i]) for i in (0, 1)]
    (ph0, ph1), (pw0, pw1) = pad
    sym = ph0 == ph1 and pw0 == pw1
    if not sym:
        inp = F.pad(inp, (pw0, pw1, ph0, ph1))
    r = F.conv2d(inp, flt, None, strides, (ph0, pw0) if sym else 0,
                 dilations, attrs.get("groups", 1) or 1)
    if nhwc:
        r = r.permute(0, 2, 3, 1)
    return {"Output": [r]}


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
    v = x(ins)
    ptype = attrs["pooling_type"]
    nhwc = attrs.get("data_format", "NCHW") == "NHWC"
    if nhwc:
        v = v.permute(0, 3, 1, 2)
    if attrs.get("global_pooling") or (attrs.get("adaptive") and
                                       list(attrs["ksize"]) == [1, 1]):
        r = v.amax((2, 3), keepdim=True) if ptype == "max" \
            else v.mean((2, 3), keepdim=True)
    elif attrs.get("adaptive"):
        # the reference's bins are torch's: [floor(i*n/o), ceil((i+1)*n/o))
        fn = F.adaptive_max_pool2d if ptype == "max" \
            else F.adaptive_avg_pool2d
        r = fn(v, list(attrs["ksize"]))
    else:
        # the reference pads by `paddings` and ignores ceil_mode here (its
        # infer_shape reads it)
        k, s = list(attrs["ksize"]), list(attrs["strides"])
        p = list(attrs["paddings"])
        if ptype == "max":
            r = F.max_pool2d(v, k, s, p)
        else:
            r = F.avg_pool2d(v, k, s, p, count_include_pad=not (
                attrs.get("exclusive", True) and (p[0] or p[1])))
    if nhwc:
        r = r.permute(0, 2, 3, 1)
    return out(r)


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
# fused transformer FFN: act(x@W1+b1)@W2+b2 with the (M, I) intermediate
# kept on chip (B row 10, ops/fused_ffn.py over csrc/fused_ffn.cu)
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

"""Tensor ops (counterpart of ``paddle_tpu/fluid/ops/tensor_ops.py``):
flatten2, fill_constant, top_k_v2 and fill_zeros_like, on torch
tensors."""
from __future__ import annotations

import math

import torch

from ..core import torch_dtype
from ..registry import register, same_shape_as
from .common import out, x


def _flatten_infer(op):
    v = op.invar("X")
    if v is None or v.shape is None:
        return
    ax = op.attr("axis", 1)
    lead, tail = v.shape[:ax], v.shape[ax:]
    lead_n = -1 if any(s < 0 for s in lead) else math.prod(lead)
    tail_n = -1 if any(s < 0 for s in tail) else math.prod(tail)
    for name in op.output("Out"):
        op.block.create_var(name=name, shape=(lead_n, tail_n), dtype=v.dtype)


def _flatten2(ctx, ins, attrs):
    v = x(ins)
    ax = attrs.get("axis", 1)
    r = v.reshape(math.prod(v.shape[:ax]) if ax else 1, -1)
    return {"Out": [r], "XShape": [None]}


register("flatten2", _flatten2, attrs={"axis": 1},
         infer_shape=_flatten_infer, no_grad_out_slots=("XShape",))


# ---------------------------------------------------------------------------
# fill
# ---------------------------------------------------------------------------

def _fill_constant_infer(op):
    shape = tuple(op.attr("shape", []))
    for name in op.output("Out"):
        op.block.create_var(name=name, shape=shape,
                            dtype=op.attr("dtype", "float32"))


@register("fill_constant", grad=None, infer_shape=_fill_constant_infer,
          attrs={"shape": [], "value": 0.0, "dtype": "float32",
                 "force_cpu": False})
def _fill_constant(ctx, ins, attrs):
    st = x(ins, "ShapeTensor")
    shape = [int(s) for s in st.tolist()] if st is not None \
        else list(attrs["shape"])
    dtype = torch_dtype(attrs["dtype"])
    vt = x(ins, "ValueTensor")
    if vt is not None:
        return out(vt.to(dtype).reshape(()).expand(shape).clone())
    return out(torch.full(shape, attrs["value"], dtype=dtype,
                          device=ctx.device))


# ---------------------------------------------------------------------------
# top-k
# ---------------------------------------------------------------------------

def _topk_infer(op):
    v = op.invar("X")
    if v is None or v.shape is None:
        return
    k = op.attr("k", 1)
    ax = op.attr("axis", -1) % len(v.shape)
    shape = list(v.shape)
    shape[ax] = k
    for name in op.output("Out"):
        op.block.create_var(name=name, shape=tuple(shape), dtype=v.dtype)
    for name in op.output("Indices"):
        op.block.create_var(name=name, shape=tuple(shape), dtype="int64")


def _topk(ctx, ins, attrs):
    v = x(ins)
    kt = x(ins, "K")
    k = int(kt.reshape(-1)[0]) if kt is not None else attrs.get("k", 1)
    vals, idx = torch.topk(v, k, dim=attrs.get("axis", -1),
                           largest=attrs.get("largest", True) is not False,
                           sorted=True)
    return {"Out": [vals], "Indices": [idx]}


register("top_k_v2", _topk, infer_shape=_topk_infer,
         attrs={"k": 1, "axis": -1, "largest": True, "sorted": True},
         no_grad_out_slots=("Indices",))


@register("fill_zeros_like", grad=None, infer_shape=same_shape_as("X"))
def _fill_zeros_like(ctx, ins, attrs):
    # append_backward zero-fills an upstream gradient nothing produced
    return out(torch.zeros_like(x(ins)))

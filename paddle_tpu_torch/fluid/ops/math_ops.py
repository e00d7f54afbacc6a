"""Dense math ops (counterpart of ``paddle_tpu/fluid/ops/math_ops.py``):
elementwise add/sub/mul with Paddle's axis broadcast, mul, relu, sum,
mean and reduce_sum, on torch tensors."""
from __future__ import annotations

import math

import torch

from ..registry import elementwise_infer, register, same_shape_as
from .common import bcast_to_x, out, static_reduce_shape, x


# ---------------------------------------------------------------------------
# elementwise binary ops (axis-broadcast semantics of the reference)
# ---------------------------------------------------------------------------

def _ew(name, fn):
    def compute(ctx, ins, attrs, _fn=fn):
        a, b = x(ins, "X"), x(ins, "Y")
        b = bcast_to_x(a, b, attrs.get("axis", -1))
        return out(_fn(a, b))
    register("elementwise_" + name, compute, attrs={"axis": -1},
             infer_shape=elementwise_infer)


_ew("add", torch.add)
_ew("sub", torch.sub)
_ew("mul", torch.mul)


# ---------------------------------------------------------------------------
# mul: the 2-D product of fc
# ---------------------------------------------------------------------------

def _mul_infer(op):
    xv, yv = op.invar("X"), op.invar("Y")
    if xv is None or xv.shape is None or yv is None or yv.shape is None:
        return
    xn = op.attr("x_num_col_dims", 1)
    yn = op.attr("y_num_col_dims", 1)
    shape = tuple(list(xv.shape[:xn]) + list(yv.shape[yn:]))
    for n in op.output("Out"):
        op.block.create_var(name=n, shape=shape, dtype=xv.dtype)


@register("mul", infer_shape=_mul_infer,
          attrs={"x_num_col_dims": 1, "y_num_col_dims": 1})
def _mul(ctx, ins, attrs):
    # reference mul_op: flatten x to 2-D at x_num_col_dims, same for y
    a, b = x(ins, "X"), x(ins, "Y")
    xn, yn = attrs["x_num_col_dims"], attrs["y_num_col_dims"]
    a2 = a.reshape(math.prod(a.shape[:xn]), -1) \
        if a.dim() > 2 or xn != 1 else a
    b2 = b.reshape(math.prod(b.shape[:yn]), -1) \
        if b.dim() > 2 or yn != 1 else b
    r = a2 @ b2
    return out(r.reshape(tuple(a.shape[:xn]) + tuple(b.shape[yn:])))


register("relu", lambda ctx, ins, attrs: out(torch.relu(x(ins))),
         infer_shape=same_shape_as("X"))


# ---------------------------------------------------------------------------
# sums and reductions
# ---------------------------------------------------------------------------

@register("sum", infer_shape=same_shape_as("X"))
def _sum(ctx, ins, attrs):
    vals = [v for v in ins.get("X", []) if v is not None]
    r = vals[0]
    for v in vals[1:]:
        r = r + v
    return out(r)


def _reduce_sum_infer(op):
    v = op.invar("X")
    if v is None or v.shape is None:
        return
    shape = static_reduce_shape(v.shape, op.attr("dim"),
                                op.attr("keep_dim", False),
                                op.attr("reduce_all", False))
    for n in op.output("Out"):
        op.block.create_var(name=n, shape=shape, dtype=v.dtype)


@register("reduce_sum", infer_shape=_reduce_sum_infer,
          attrs={"dim": [0], "keep_dim": False, "reduce_all": False})
def _reduce_sum(ctx, ins, attrs):
    v = x(ins)
    if attrs.get("reduce_all") or not attrs.get("dim"):
        r = v.sum(dim=tuple(range(v.dim())), keepdim=attrs.get("keep_dim",
                                                              False))
    else:
        r = v.sum(dim=tuple(d % v.dim() for d in attrs["dim"]),
                  keepdim=attrs.get("keep_dim", False))
    return out(r.reshape(1) if r.dim() == 0 else r)


def _mean_infer(op):
    v = op.invar("X")
    for n in op.output("Out"):
        op.block.create_var(name=n, shape=(1,),
                            dtype=v.dtype if v is not None else "float32")


@register("mean", infer_shape=_mean_infer)
def _mean(ctx, ins, attrs):
    return out(x(ins).mean().reshape(1))

"""Dense math ops (counterpart of ``paddle_tpu/fluid/ops/math_ops.py``):
elementwise binaries with Paddle's axis broadcast, the matmul family,
activations, reductions and norms, comparisons and logic, and the rest
of the module (cumsum, bmm, addmm, dot, clip, scale), on torch tensors.

``sum`` carries SelectedRows (``fluid/selected_rows.py``): the sum of
sparse gradients only is their rows and values concatenated (consumers
scatter-add), a mix is summed dense. ``merge_selected_rows`` folds
duplicate rows and ``get_tensor_from_selected_rows`` scatters the rows
into a dense table; both return a dense tensor unchanged, as the
reference's do.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..registry import elementwise_infer, register, same_shape_as
from ..selected_rows import SelectedRows
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
_ew("div", torch.div)
_ew("max", torch.maximum)
_ew("min", torch.minimum)
_ew("pow", torch.pow)
_ew("mod", torch.remainder)
_ew("floordiv", torch.floor_divide)


# ---------------------------------------------------------------------------
# the matmul family
# ---------------------------------------------------------------------------

def _matmul_infer(op):
    xv, yv = op.invar("X"), op.invar("Y")
    if xv is None or yv is None or xv.shape is None or yv.shape is None:
        return
    tx = op.attr("transpose_X", op.attr("trans_x", False))
    ty = op.attr("transpose_Y", op.attr("trans_y", False))
    xs, ys = list(xv.shape), list(yv.shape)
    if len(xs) == 1:
        xs = [1, xs[0]]
    if len(ys) == 1:
        ys = [ys[0], 1]
    if tx:
        xs[-1], xs[-2] = xs[-2], xs[-1]
    if ty:
        ys[-1], ys[-2] = ys[-2], ys[-1]
    batch = xs[:-2] if len(xs) >= len(ys) else ys[:-2]
    shape = tuple(batch + [xs[-2], ys[-1]])
    for n in op.output("Out"):
        op.block.create_var(name=n, shape=shape, dtype=xv.dtype)


def _matmul(ctx, ins, attrs):
    a, b = x(ins, "X"), x(ins, "Y")
    if attrs.get("transpose_X") or attrs.get("trans_x"):
        a = a.transpose(-1, -2) if a.dim() > 1 else a
    if attrs.get("transpose_Y") or attrs.get("trans_y"):
        b = b.transpose(-1, -2) if b.dim() > 1 else b
    r = torch.matmul(a, b)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        r = r * alpha
    return out(r)


register("matmul", _matmul, infer_shape=_matmul_infer,
         attrs={"transpose_X": False, "transpose_Y": False, "alpha": 1.0})
register("matmul_v2", _matmul, infer_shape=_matmul_infer,
         attrs={"trans_x": False, "trans_y": False})


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


@register("bmm", infer_shape=_matmul_infer)
def _bmm(ctx, ins, attrs):
    return out(torch.matmul(x(ins, "X"), x(ins, "Y")))


@register("addmm", attrs={"Alpha": 1.0, "Beta": 1.0})
def _addmm(ctx, ins, attrs):
    inp, a, b = x(ins, "Input"), x(ins, "X"), x(ins, "Y")
    return out(attrs["Beta"] * inp + attrs["Alpha"] * (a @ b))


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def _act(name, fn, extra_attrs=None):
    def compute(ctx, ins, attrs, _fn=fn):
        return out(_fn(x(ins), attrs))
    register(name, compute, attrs=extra_attrs or {},
             infer_shape=same_shape_as("X"))


def _where0(cond, v):
    return torch.where(cond, v, torch.zeros_like(v))


def _softshrink(v, a):
    lam = a.get("lambda", 0.5)
    return torch.where(v > lam, v - lam,
                       torch.where(v < -lam, v + lam, torch.zeros_like(v)))


_act("relu", lambda v, a: torch.relu(v))
_act("relu6", lambda v, a: torch.clamp(v, 0, a.get("threshold", 6.0)),
     {"threshold": 6.0})
_act("sigmoid", lambda v, a: torch.sigmoid(v))
_act("tanh", lambda v, a: torch.tanh(v))
_act("exp", lambda v, a: torch.exp(v))
_act("log", lambda v, a: torch.log(v))
_act("log2", lambda v, a: torch.log2(v))
_act("log10", lambda v, a: torch.log10(v))
_act("log1p", lambda v, a: torch.log1p(v))
_act("sqrt", lambda v, a: torch.sqrt(v))
_act("rsqrt", lambda v, a: torch.rsqrt(v))
_act("square", lambda v, a: torch.square(v))
_act("abs", lambda v, a: torch.abs(v))
_act("ceil", lambda v, a: torch.ceil(v))
_act("floor", lambda v, a: torch.floor(v))
_act("round", lambda v, a: torch.round(v))
_act("reciprocal", lambda v, a: 1.0 / v)
_act("sin", lambda v, a: torch.sin(v))
_act("cos", lambda v, a: torch.cos(v))
_act("tan", lambda v, a: torch.tan(v))
_act("asin", lambda v, a: torch.asin(v))
_act("acos", lambda v, a: torch.acos(v))
_act("atan", lambda v, a: torch.atan(v))
_act("sinh", lambda v, a: torch.sinh(v))
_act("cosh", lambda v, a: torch.cosh(v))
_act("gelu", lambda v, a: F.gelu(
    v, approximate="tanh" if a.get("approximate", False) else "none"),
    {"approximate": False})
_act("leaky_relu", lambda v, a: F.leaky_relu(v, a.get("alpha", 0.02)),
     {"alpha": 0.02})
_act("elu", lambda v, a: F.elu(v, a.get("alpha", 1.0)), {"alpha": 1.0})
_act("selu", lambda v, a: F.selu(v),
     {"scale": 1.0507009873554805, "alpha": 1.6732632423543772})
_act("softplus", lambda v, a: torch.logaddexp(v, torch.zeros_like(v)))
_act("softsign", lambda v, a: F.softsign(v))
_act("silu", lambda v, a: F.silu(v))
_act("swish", lambda v, a: v * torch.sigmoid(a.get("beta", 1.0) * v),
     {"beta": 1.0})
_act("mish", lambda v, a: v * torch.tanh(
    torch.logaddexp(v, torch.zeros_like(v))))
_act("hard_sigmoid",
     lambda v, a: torch.clamp(a.get("slope", 0.2) * v
                              + a.get("offset", 0.5), 0, 1),
     {"slope": 0.2, "offset": 0.5})
_act("hard_swish",
     lambda v, a: v * torch.clamp(v + a.get("offset", 3.0), 0,
                                  a.get("threshold", 6.0))
     / a.get("scale", 6.0),
     {"threshold": 6.0, "scale": 6.0, "offset": 3.0})
_act("hard_tanh",
     lambda v, a: torch.clamp(v, a.get("t_min", -1.0), a.get("t_max", 1.0)),
     {"t_min": -1.0, "t_max": 1.0})
_act("logsigmoid", lambda v, a: F.logsigmoid(v))
_act("erf", lambda v, a: torch.erf(v))
_act("tanh_shrink", lambda v, a: v - torch.tanh(v))
_act("softshrink", _softshrink, {"lambda": 0.5})
_act("hard_shrink",
     lambda v, a: _where0(torch.abs(v) > a.get("threshold", 0.5), v),
     {"threshold": 0.5})
_act("thresholded_relu",
     lambda v, a: _where0(v > a.get("threshold", 1.0), v),
     {"threshold": 1.0})
_act("stanh",
     lambda v, a: a.get("scale_b", 1.7159)
     * torch.tanh(a.get("scale_a", 0.67) * v),
     {"scale_a": 0.67, "scale_b": 1.7159})
_act("sign", lambda v, a: torch.sign(v))


@register("pow", infer_shape=same_shape_as("X"), attrs={"factor": 1.0})
def _pow(ctx, ins, attrs):
    f = x(ins, "FactorTensor")
    return out(torch.pow(x(ins), f if f is not None else attrs["factor"]))


@register("clip", infer_shape=same_shape_as("X"),
          attrs={"min": float("-inf"), "max": float("inf")})
def _clip(ctx, ins, attrs):
    lo, hi = x(ins, "Min"), x(ins, "Max")
    lo = attrs["min"] if lo is None else lo.reshape(())
    hi = attrs["max"] if hi is None else hi.reshape(())
    return out(torch.clamp(x(ins), lo, hi))


@register("scale", infer_shape=same_shape_as("X"),
          attrs={"scale": 1.0, "bias": 0.0, "bias_after_scale": True})
def _scale(ctx, ins, attrs):
    v = x(ins)
    s = x(ins, "ScaleTensor")
    s = attrs["scale"] if s is None else s
    if attrs["bias_after_scale"]:
        return out(v * s + attrs["bias"])
    return out((v + attrs["bias"]) * s)


# ---------------------------------------------------------------------------
# sums and the dense forms of the selected-rows helpers
# ---------------------------------------------------------------------------

@register("sum", infer_shape=same_shape_as("X"))
def _sum(ctx, ins, attrs):
    vals = [v for v in ins.get("X", []) if v is not None]
    srs = [v for v in vals if isinstance(v, SelectedRows)]
    if srs:
        if len(srs) == len(vals):
            # sparse gradients only: the concatenation is the sum
            # (consumers scatter-add the duplicate rows)
            return out(SelectedRows(torch.cat([s.rows for s in srs]),
                                    torch.cat([s.values for s in srs]),
                                    srs[0].height))
        vals = [v.to_dense() if isinstance(v, SelectedRows) else v
                for v in vals]
    r = vals[0]
    for v in vals[1:]:
        r = r + v
    return out(r)


@register("merge_selected_rows", grad=None)
def _merge_selected_rows(ctx, ins, attrs):
    sr = x(ins)
    return out(sr.merged() if isinstance(sr, SelectedRows) else sr)


@register("get_tensor_from_selected_rows", grad=None)
def _get_tensor_from_selected_rows(ctx, ins, attrs):
    sr = x(ins)
    return out(sr.to_dense() if isinstance(sr, SelectedRows) else sr)


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

def _prod(v, axis, keepdims):
    for d in sorted(axis, reverse=True):
        v = v.prod(d, keepdim=keepdims)
    return v


_REDUCERS = {
    "reduce_sum": lambda v, ax, k: v.sum(dim=ax, keepdim=k),
    "reduce_mean": lambda v, ax, k: v.mean(dim=ax, keepdim=k),
    "reduce_max": lambda v, ax, k: v.amax(dim=ax, keepdim=k),
    "reduce_min": lambda v, ax, k: v.amin(dim=ax, keepdim=k),
    "reduce_prod": _prod,
    "reduce_any": lambda v, ax, k: v.bool().any(dim=ax, keepdim=k),
    "reduce_all": lambda v, ax, k: v.bool().all(dim=ax, keepdim=k),
}


def _reduce(name, fn):
    def infer(op):
        v = op.invar("X")
        if v is None or v.shape is None:
            return
        shape = static_reduce_shape(v.shape, op.attr("dim"),
                                    op.attr("keep_dim", False),
                                    op.attr("reduce_all", False))
        for n in op.output("Out"):
            op.block.create_var(name=n, shape=shape, dtype=v.dtype)

    def compute(ctx, ins, attrs, _fn=fn):
        v = x(ins)
        axes = tuple(range(v.dim())) \
            if attrs.get("reduce_all") or not attrs.get("dim") \
            else tuple(d % v.dim() for d in attrs["dim"])
        r = _fn(v, axes, attrs.get("keep_dim", False))
        return out(r.reshape(1) if r.dim() == 0 else r)

    register(name, compute, infer_shape=infer,
             attrs={"dim": [0], "keep_dim": False, "reduce_all": False})


for _name, _fn in _REDUCERS.items():
    _reduce(_name, _fn)


def _mean_infer(op):
    v = op.invar("X")
    for n in op.output("Out"):
        op.block.create_var(name=n, shape=(1,),
                            dtype=v.dtype if v is not None else "float32")


@register("mean", infer_shape=_mean_infer)
def _mean(ctx, ins, attrs):
    return out(x(ins).mean().reshape(1))


@register("squared_l2_norm", infer_shape=_mean_infer)
def _squared_l2_norm(ctx, ins, attrs):
    return out(torch.square(x(ins)).sum().reshape(1))


@register("frobenius_norm", infer_shape=_mean_infer)
def _frobenius_norm(ctx, ins, attrs):
    return out(torch.sqrt(torch.square(x(ins)).sum()).reshape(1))


@register("p_norm", infer_shape=_mean_infer,
          attrs={"porder": 2.0, "axis": -1, "epsilon": 1e-12,
                 "keepdim": False, "asvector": False})
def _p_norm(ctx, ins, attrs):
    v = x(ins)
    p = attrs["porder"]
    if attrs.get("asvector"):
        return out((torch.abs(v) ** p).sum().pow(1.0 / p).reshape(1))
    return out((torch.abs(v) ** p).sum(attrs["axis"],
                                       keepdim=attrs["keepdim"])
               .pow(1.0 / p))


# ---------------------------------------------------------------------------
# comparison / logical (non-differentiable)
# ---------------------------------------------------------------------------

def _cmp(name, fn):
    def infer(op):
        v = op.invar("X")
        if v is None:
            return
        for n in op.output("Out"):
            op.block.create_var(name=n, shape=v.shape, dtype="bool")

    def compute(ctx, ins, attrs, _fn=fn):
        return out(_fn(x(ins, "X"), x(ins, "Y")))
    register(name, compute, grad=None, infer_shape=infer, attrs={"axis": -1})


_cmp("equal", torch.eq)
_cmp("not_equal", torch.ne)
_cmp("less_than", torch.lt)
_cmp("less_equal", torch.le)
_cmp("greater_than", torch.gt)
_cmp("greater_equal", torch.ge)
_cmp("logical_and", torch.logical_and)
_cmp("logical_or", torch.logical_or)
_cmp("logical_xor", torch.logical_xor)


@register("logical_not", grad=None, infer_shape=same_shape_as("X"))
def _logical_not(ctx, ins, attrs):
    return out(torch.logical_not(x(ins)))


@register("isfinite", grad=None, infer_shape=_mean_infer)
def _isfinite(ctx, ins, attrs):
    return out(torch.isfinite(x(ins)).all().reshape(1))


register("isfinite_v2", lambda ctx, ins, attrs: out(torch.isfinite(x(ins))),
         grad=None, infer_shape=same_shape_as("X"))
register("isnan_v2", lambda ctx, ins, attrs: out(torch.isnan(x(ins))),
         grad=None, infer_shape=same_shape_as("X"))
register("isinf_v2", lambda ctx, ins, attrs: out(torch.isinf(x(ins))),
         grad=None, infer_shape=same_shape_as("X"))


# ---------------------------------------------------------------------------
# misc math
# ---------------------------------------------------------------------------

register("maximum", lambda ctx, ins, attrs: out(
    torch.maximum(x(ins, "X"), x(ins, "Y"))), infer_shape=elementwise_infer)
register("minimum", lambda ctx, ins, attrs: out(
    torch.minimum(x(ins, "X"), x(ins, "Y"))), infer_shape=elementwise_infer)


@register("dot", infer_shape=_mean_infer)
def _dot(ctx, ins, attrs):
    return out((x(ins, "X") * x(ins, "Y")).sum(-1, keepdim=True))


@register("cumsum", infer_shape=same_shape_as("X"),
          attrs={"axis": -1, "flatten": False, "exclusive": False,
                 "reverse": False})
def _cumsum(ctx, ins, attrs):
    v = x(ins)
    if attrs.get("flatten"):
        v = v.reshape(-1)
    axis = attrs["axis"]
    if attrs.get("reverse"):
        v = torch.flip(v, (axis,))
    r = torch.cumsum(v, axis)
    if attrs.get("exclusive"):
        r = r - v
    if attrs.get("reverse"):
        r = torch.flip(r, (axis,))
    return out(r)

"""Tensor ops (counterpart of ``paddle_tpu/fluid/ops/tensor_ops.py``):
reshape, transpose, squeeze and flatten; concat, split and stack;
slicing, gathers and scatters; expand and tile; the fill and creation
ops; cast; arg-max/min, sorts and top-k; and the rest of the module, on
torch tensors. Every tensor an op creates lies on ``ctx.device``.

``unique`` keeps the reference's static shape: the unique values padded
to the input's size (the reference pads with its fill value, the
smallest element), and the inverse index.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import torch_dtype
from ..registry import register, same_shape_as
from .common import out, x


def _ints(t):
    """A shape or axis given as a tensor, as python ints."""
    return [int(s) for s in t.reshape(-1).tolist()]


def _mk_out(op, shape, dtype, slot="Out"):
    for n in op.output(slot):
        op.block.create_var(name=n, shape=None if shape is None
                            else tuple(shape), dtype=dtype)


def _dtype_or(v, dt):
    """The torch dtype of attr `dt`; -1 / None keep v's."""
    return v.dtype if dt in (-1, None) else torch_dtype(dt)


# ---------------------------------------------------------------------------
# shape manipulation
# ---------------------------------------------------------------------------

def _reshape_infer(op):
    v = op.invar("X")
    if v is None or v.shape is None:
        return
    shape = list(op.attr("shape", []))
    for i, s in enumerate(shape):
        if s == 0:
            shape[i] = v.shape[i]
    if -1 in shape and all(s >= 0 for s in v.shape):
        i = shape.index(-1)
        known = math.prod(s for s in shape if s != -1) or 1
        shape[i] = math.prod(v.shape) // known
    _mk_out(op, shape, v.dtype)


def _reshape(ctx, ins, attrs):
    v = x(ins)
    st = x(ins, "ShapeTensor")
    if st is None:
        st = x(ins, "Shape")
    shape = _ints(st) if st is not None else list(attrs.get("shape", []))
    shape = [v.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return {"Out": [v.reshape(shape)], "XShape": [None]}


register("reshape2", _reshape, infer_shape=_reshape_infer,
         attrs={"shape": []}, no_grad_out_slots=("XShape",))
register("reshape", _reshape, infer_shape=_reshape_infer, attrs={"shape": []})


def _transpose_infer(op):
    v = op.invar("X")
    if v is None or v.shape is None:
        return
    _mk_out(op, [v.shape[p] for p in op.attr("axis", [])], v.dtype)


def _transpose(ctx, ins, attrs):
    return {"Out": [x(ins).permute(*attrs["axis"])], "XShape": [None]}


register("transpose2", _transpose, infer_shape=_transpose_infer,
         attrs={"axis": []}, no_grad_out_slots=("XShape",))
register("transpose", _transpose, infer_shape=_transpose_infer,
         attrs={"axis": []})


def _squeeze_infer(op):
    v = op.invar("X")
    if v is None or v.shape is None:
        return
    axes = op.attr("axes", [])
    nd = len(v.shape)
    if axes:
        shape = [s for i, s in enumerate(v.shape)
                 if not (i in axes or i - nd in axes) or s != 1]
    else:
        shape = [s for s in v.shape if s != 1]
    _mk_out(op, shape, v.dtype)


def _squeeze(ctx, ins, attrs):
    v = x(ins)
    axes = attrs.get("axes", [])
    if not axes:
        r = v.reshape([s for s in v.shape if s != 1])
    else:
        drop = {a % v.dim() for a in axes if v.shape[a % v.dim()] == 1}
        r = v.reshape([s for i, s in enumerate(v.shape) if i not in drop])
    return {"Out": [r], "XShape": [None]}


register("squeeze2", _squeeze, attrs={"axes": []},
         infer_shape=_squeeze_infer, no_grad_out_slots=("XShape",))
register("squeeze", _squeeze, attrs={"axes": []}, infer_shape=_squeeze_infer)


def _unsqueeze_infer(op):
    v = op.invar("X")
    if v is None or v.shape is None:
        return
    shape = list(v.shape)
    for a in sorted(op.attr("axes", [])):
        shape.insert(a if a >= 0 else a + len(shape) + 1, 1)
    _mk_out(op, shape, v.dtype)


def _unsqueeze(ctx, ins, attrs):
    v = x(ins)
    for a in sorted(attrs["axes"]):
        v = v.unsqueeze(a)
    return {"Out": [v], "XShape": [None]}


register("unsqueeze2", _unsqueeze, attrs={"axes": []},
         infer_shape=_unsqueeze_infer, no_grad_out_slots=("XShape",))
register("unsqueeze", _unsqueeze, attrs={"axes": []},
         infer_shape=_unsqueeze_infer)


def _flatten_infer(op):
    v = op.invar("X")
    if v is None or v.shape is None:
        return

    def _n(dims):
        return -1 if any(s < 0 for s in dims) else math.prod(dims)

    if op.type.startswith("flatten_contiguous"):
        start = op.attr("start_axis", 1)
        stop = op.attr("stop_axis", -1) % len(v.shape)
        shape = tuple(v.shape[:start]) + (_n(v.shape[start:stop + 1]),) \
            + tuple(v.shape[stop + 1:])
    else:
        ax = op.attr("axis", 1)
        shape = (_n(v.shape[:ax]), _n(v.shape[ax:]))
    _mk_out(op, shape, v.dtype)


def _flatten_range(ctx, ins, attrs):
    v = x(ins)
    start = attrs.get("start_axis", 1)
    stop = attrs.get("stop_axis", -1) % v.dim()
    shape = tuple(v.shape[:start]) + (-1,) + tuple(v.shape[stop + 1:])
    return {"Out": [v.reshape(shape)], "XShape": [None]}


register("flatten_contiguous_range", _flatten_range,
         attrs={"start_axis": 1, "stop_axis": -1},
         infer_shape=_flatten_infer, no_grad_out_slots=("XShape",))


def _flatten2(ctx, ins, attrs):
    v = x(ins)
    ax = attrs.get("axis", 1)
    r = v.reshape(math.prod(v.shape[:ax]) if ax else 1, -1)
    return {"Out": [r], "XShape": [None]}


register("flatten2", _flatten2, attrs={"axis": 1},
         infer_shape=_flatten_infer, no_grad_out_slots=("XShape",))
register("flatten", lambda ctx, ins, attrs: {
    "Out": _flatten2(ctx, ins, attrs)["Out"]},
    attrs={"axis": 1}, infer_shape=_flatten_infer)


# ---------------------------------------------------------------------------
# concat / split / stack
# ---------------------------------------------------------------------------

def _concat_infer(op):
    vs = [op.block._var_recursive(n) for n in op.input("X")]
    if not vs or any(v is None or v.shape is None for v in vs):
        return
    ax = op.attr("axis", 0) % len(vs[0].shape)
    shape = list(vs[0].shape)
    shape[ax] = sum(v.shape[ax] for v in vs) \
        if all(v.shape[ax] >= 0 for v in vs) else -1
    _mk_out(op, shape, vs[0].dtype)


@register("concat", infer_shape=_concat_infer, attrs={"axis": 0})
def _concat(ctx, ins, attrs):
    ax = x(ins, "AxisTensor")
    axis = int(ax.reshape(())) if ax is not None else attrs["axis"]
    return out(torch.cat(ins["X"], dim=axis))


def _split_infer(op):
    v = op.invar("X")
    if v is None or v.shape is None:
        return
    ax = op.attr("axis", 0) % len(v.shape)
    sections = op.attr("sections", [])
    names = op.output("Out")
    if sections:
        sizes = sections
    else:
        n = op.attr("num", 0) or len(names)
        sizes = [v.shape[ax] // n] * n if v.shape[ax] >= 0 else [-1] * n
    for name, s in zip(names, sizes):
        shape = list(v.shape)
        shape[ax] = s
        op.block.create_var(name=name, shape=tuple(shape), dtype=v.dtype)


@register("split", infer_shape=_split_infer,
          attrs={"axis": 0, "num": 0, "sections": []})
def _split(ctx, ins, attrs):
    v = x(ins)
    ax = attrs["axis"]
    sections = attrs.get("sections") or []
    if sections:
        parts = torch.split(v, list(sections), dim=ax)
    else:
        n = attrs.get("num") or 1
        parts = torch.split(v, v.shape[ax] // n, dim=ax)
    return {"Out": list(parts)}


def _stack_infer(op):
    vs = [op.block._var_recursive(n) for n in op.input("X")]
    if not vs or any(v is None or v.shape is None for v in vs):
        return
    ax = op.attr("axis", 0)
    shape = list(vs[0].shape)
    shape.insert(ax if ax >= 0 else ax + len(shape) + 1, len(vs))
    _mk_out(op, shape, vs[0].dtype, "Y")


@register("stack", infer_shape=_stack_infer, attrs={"axis": 0})
def _stack(ctx, ins, attrs):
    return {"Y": [torch.stack(ins["X"], dim=attrs["axis"])]}


def _drop_axis_infer(slot):
    """unstack/unbind: every output is X's shape minus the split axis."""
    def _infer(op):
        v = op.invar("X")
        if v is None or v.shape is None:
            return
        ax = op.attr("axis", 0) % len(v.shape)
        _mk_out(op, [s for i, s in enumerate(v.shape) if i != ax],
                v.dtype, slot=slot)
    return _infer


register("unstack", lambda ctx, ins, attrs: {
    "Y": list(torch.unbind(x(ins), attrs["axis"]))},
    attrs={"axis": 0, "num": 0}, infer_shape=_drop_axis_infer("Y"))
register("unbind", lambda ctx, ins, attrs: {
    "Out": list(torch.unbind(x(ins), attrs["axis"]))},
    attrs={"axis": 0}, infer_shape=_drop_axis_infer("Out"))


# ---------------------------------------------------------------------------
# slicing / gather / scatter
# ---------------------------------------------------------------------------

def _slice_infer(op):
    v = op.invar("Input")
    if v is None or v.shape is None:
        return
    shape = list(v.shape)
    for a, s, e in zip(op.attr("axes", []), op.attr("starts", []),
                       op.attr("ends", [])):
        if shape[a] < 0:
            continue
        s2 = s if s >= 0 else s + shape[a]
        e2 = min(e if e >= 0 else e + shape[a], shape[a])
        shape[a] = max(e2 - s2, 0)
    for d in sorted(op.attr("decrease_axis", []), reverse=True):
        shape.pop(d)
    _mk_out(op, shape, v.dtype)


def _strided_slice_infer(op):
    v = op.invar("Input")
    if v is None or v.shape is None:
        return
    shape = list(v.shape)
    for a, s, e, st in zip(op.attr("axes", []), op.attr("starts", []),
                           op.attr("ends", []), op.attr("strides", [])):
        if shape[a] >= 0:
            shape[a] = len(range(*slice(s, e, st).indices(shape[a])))
    for d in sorted(op.attr("decrease_axis", []), reverse=True):
        shape.pop(d)
    _mk_out(op, shape, v.dtype)


def _take_slices(v, axes, starts, ends, strides, dec):
    """v[slices] with python's slice rules; a negative stride flips."""
    idx = [slice(None)] * v.dim()
    flips = []
    for a, s, e, st in zip(axes, starts, ends, strides):
        rng = range(*slice(s, e, st).indices(v.shape[a]))
        if st > 0:
            idx[a] = slice(rng.start, rng.stop if len(rng) else rng.start,
                           st)
        else:
            idx[a] = torch.tensor(list(rng), dtype=torch.long,
                                  device=v.device)
            flips.append(a)
    r = v
    for a, ix in enumerate(idx):
        if isinstance(ix, torch.Tensor):
            r = r.index_select(a, ix)
        elif ix != slice(None):
            r = r[(slice(None),) * a + (ix,)]
    if dec:
        r = r.reshape([d for i, d in enumerate(r.shape) if i not in dec])
    return r


@register("slice", infer_shape=_slice_infer,
          attrs={"axes": [], "starts": [], "ends": [], "decrease_axis": [],
                 "infer_flags": []})
def _slice(ctx, ins, attrs):
    v = x(ins, "Input")
    axes = attrs["axes"]
    return out(_take_slices(v, axes, attrs["starts"], attrs["ends"],
                            [1] * len(axes), attrs.get("decrease_axis", [])))


@register("strided_slice", infer_shape=_strided_slice_infer,
          attrs={"axes": [], "starts": [], "ends": [], "strides": [],
                 "infer_flags": [], "decrease_axis": []})
def _strided_slice(ctx, ins, attrs):
    return out(_take_slices(x(ins, "Input"), attrs["axes"], attrs["starts"],
                            attrs["ends"], attrs["strides"],
                            attrs.get("decrease_axis", [])))


def _gather_infer(op):
    v, ids = op.invar("X"), op.invar("Index")
    if v is None or v.shape is None or ids is None or ids.shape is None:
        return
    _mk_out(op, list(ids.shape[:1]) + list(v.shape[1:]), v.dtype)


@register("gather", infer_shape=_gather_infer, no_grad_slots=("Index",),
          attrs={"axis": 0})
def _gather(ctx, ins, attrs):
    v, idx = x(ins), x(ins, "Index")
    ax = x(ins, "Axis")
    axis = int(ax.reshape(())) if ax is not None else attrs.get("axis", 0)
    if idx.dim() == 2 and idx.shape[1] == 1:
        idx = idx[:, 0]
    return out(torch.index_select(v, axis, idx.long().reshape(-1))
               .reshape(tuple(v.shape[:axis]) + tuple(idx.shape)
                        + tuple(v.shape[axis + 1:])))


def _gather_nd_infer(op):
    v, idx = op.invar("X"), op.invar("Index")
    if None in (v, idx) or v.shape is None or idx.shape is None:
        return
    k = idx.shape[-1]
    _mk_out(op, tuple(idx.shape[:-1]) + tuple(v.shape[k:]), v.dtype)


@register("gather_nd", no_grad_slots=("Index",), infer_shape=_gather_nd_infer)
def _gather_nd(ctx, ins, attrs):
    v, idx = x(ins), x(ins, "Index").long()
    return out(v[tuple(idx[..., i] for i in range(idx.shape[-1]))])


def _index_select_infer(op):
    v, idx = op.invar("X"), op.invar("Index")
    if None in (v, idx) or v.shape is None or idx.shape is None:
        return
    shape = list(v.shape)
    shape[op.attr("dim", 0)] = idx.shape[0]
    _mk_out(op, shape, v.dtype)


@register("index_select", no_grad_slots=("Index",), attrs={"dim": 0},
          infer_shape=_index_select_infer)
def _index_select(ctx, ins, attrs):
    return out(torch.index_select(x(ins), attrs["dim"],
                                  x(ins, "Index").long()))


def _index_sample_infer(op):
    v, idx = op.invar("X"), op.invar("Index")
    if None in (v, idx) or v.shape is None or idx.shape is None:
        return
    _mk_out(op, (v.shape[0], idx.shape[1]), v.dtype)


@register("index_sample", no_grad_slots=("Index",),
          infer_shape=_index_sample_infer)
def _index_sample(ctx, ins, attrs):
    return out(torch.gather(x(ins), 1, x(ins, "Index").long()))


@register("scatter", no_grad_slots=("Ids",), attrs={"overwrite": True},
          infer_shape=same_shape_as("X"))
def _scatter(ctx, ins, attrs):
    v, ids, upd = x(ins), x(ins, "Ids").long(), x(ins, "Updates")
    if ids.dim() == 2 and ids.shape[1] == 1:
        ids = ids[:, 0]
    if attrs.get("overwrite", True):
        return out(v.index_put((ids,), upd.to(v.dtype)))
    return out(v.index_add(0, ids, upd.to(v.dtype)))


@register("scatter_nd_add", no_grad_slots=("Index",),
          infer_shape=same_shape_as("X"))
def _scatter_nd_add(ctx, ins, attrs):
    v, idx, upd = x(ins), x(ins, "Index").long(), x(ins, "Updates")
    key = tuple(idx[..., i] for i in range(idx.shape[-1]))
    return out(v.index_put(key, upd.to(v.dtype), accumulate=True))


@register("where", no_grad_slots=("Condition",),
          infer_shape=same_shape_as("X"))
def _where(ctx, ins, attrs):
    return out(torch.where(x(ins, "Condition").bool(), x(ins, "X"),
                           x(ins, "Y")))


@register("masked_fill", no_grad_slots=("Mask",), attrs={"value": 0.0},
          infer_shape=same_shape_as("X"))
def _masked_fill(ctx, ins, attrs):
    return out(x(ins).masked_fill(x(ins, "Mask").bool(), attrs["value"]))


# ---------------------------------------------------------------------------
# expand / tile
# ---------------------------------------------------------------------------

def _expand_v2_infer(op):
    v = op.invar("X")
    if v is None or v.shape is None:
        return
    shape = list(op.attr("shape", []))
    xs = [1] * (len(shape) - len(v.shape)) + list(v.shape)
    _mk_out(op, [xs[i] if s == -1 else s for i, s in enumerate(shape)],
            v.dtype)


@register("expand_v2", infer_shape=_expand_v2_infer, attrs={"shape": []})
def _expand_v2(ctx, ins, attrs):
    v = x(ins)
    shape = list(attrs["shape"])
    xs = [1] * (len(shape) - v.dim()) + list(v.shape)
    final = [xs[i] if s == -1 else s for i, s in enumerate(shape)]
    return out(v.reshape(xs).expand(final))


def _tile_infer(op):
    v = op.invar("X")
    if v is None or v.shape is None:
        return
    rep = list(op.attr("repeat_times", []) or op.attr("expand_times", []))
    shape = [1] * (len(rep) - len(v.shape)) + list(v.shape)
    rep = [1] * (len(shape) - len(rep)) + rep
    _mk_out(op, [s * r if s >= 0 else s for s, r in zip(shape, rep)],
            v.dtype)


def _tile(v, reps):
    reps = list(reps)
    if len(reps) < v.dim():
        reps = [1] * (v.dim() - len(reps)) + reps
    return v.repeat(*reps)


register("expand", lambda ctx, ins, attrs: out(
    _tile(x(ins), attrs["expand_times"])),
    attrs={"expand_times": []}, infer_shape=_tile_infer)
register("tile", lambda ctx, ins, attrs: out(
    _tile(x(ins), attrs["repeat_times"])),
    attrs={"repeat_times": []}, infer_shape=_tile_infer)


@register("expand_as_v2", no_grad_slots=("target_tensor", "Y"))
def _expand_as(ctx, ins, attrs):
    tgt = x(ins, "target_tensor")
    if tgt is None:
        tgt = x(ins, "Y")
    return out(x(ins).expand(tgt.shape))


# ---------------------------------------------------------------------------
# fill / creation ops
# ---------------------------------------------------------------------------

def _fill_constant_infer(op):
    _mk_out(op, op.attr("shape", []), op.attr("dtype", "float32"))


@register("fill_constant", grad=None, infer_shape=_fill_constant_infer,
          attrs={"shape": [], "value": 0.0, "dtype": "float32",
                 "force_cpu": False})
def _fill_constant(ctx, ins, attrs):
    st = x(ins, "ShapeTensor")
    shape = _ints(st) if st is not None else list(attrs["shape"])
    dtype = torch_dtype(attrs["dtype"])
    vt = x(ins, "ValueTensor")
    if vt is not None:
        return out(vt.to(dtype).reshape(()).expand(shape).clone())
    return out(torch.full(shape, attrs["value"], dtype=dtype,
                          device=ctx.device))


@register("fill_zeros_like", grad=None, infer_shape=same_shape_as("X"))
def _fill_zeros_like(ctx, ins, attrs):
    # append_backward zero-fills an upstream gradient nothing produced
    return out(torch.zeros_like(x(ins)))


@register("fill_any_like", grad=None, infer_shape=same_shape_as("X"),
          attrs={"value": 0.0, "dtype": -1})
def _fill_any_like(ctx, ins, attrs):
    v = x(ins)
    return out(torch.full(v.shape, attrs["value"],
                          dtype=_dtype_or(v, attrs.get("dtype", -1)),
                          device=v.device))


@register("assign", infer_shape=same_shape_as("X"))
def _assign(ctx, ins, attrs):
    return out(x(ins))


@register("assign_value", grad=None, infer_shape=_fill_constant_infer,
          attrs={"shape": [], "dtype": "float32", "fp32_values": [],
                 "int32_values": [], "int64_values": [], "bool_values": []})
def _assign_value(ctx, ins, attrs):
    vals = attrs.get("fp32_values") or attrs.get("int32_values") or \
        attrs.get("int64_values") or attrs.get("bool_values")
    return out(torch.tensor(vals, dtype=torch_dtype(attrs["dtype"]),
                            device=ctx.device).reshape(attrs["shape"]))


def _shape_infer(op):
    v = op.invar("Input")
    if v is None or v.shape is None:
        return
    _mk_out(op, (len(v.shape),), "int32")


@register("shape", grad=None, infer_shape=_shape_infer)
def _shape(ctx, ins, attrs):
    v = x(ins, "Input")
    return out(torch.tensor(list(v.shape), dtype=torch.int32,
                            device=v.device))


def _eye_infer(op):
    r, c = op.attr("num_rows", 0), op.attr("num_columns", -1)
    _mk_out(op, (r, c if c > 0 else r), op.attr("dtype", "float32"))


@register("eye", grad=None, infer_shape=_eye_infer,
          attrs={"num_rows": 0, "num_columns": -1, "dtype": "float32"})
def _eye(ctx, ins, attrs):
    nc = attrs["num_columns"]
    return out(torch.eye(attrs["num_rows"],
                         nc if nc > 0 else attrs["num_rows"],
                         dtype=torch_dtype(attrs["dtype"]),
                         device=ctx.device))


@register("linspace", grad=None, attrs={"dtype": "float32"})
def _linspace(ctx, ins, attrs):
    start, stop = x(ins, "Start"), x(ins, "Stop")
    num = int(x(ins, "Num").reshape(()))
    return out(torch.linspace(float(start.reshape(())),
                              float(stop.reshape(())), num,
                              dtype=torch_dtype(attrs["dtype"]),
                              device=start.device))


def _range_infer(op):
    """Static length when Start/End/Step come from attr-valued
    fill_constant ops (the arange(0, seq_len, 1) pattern)."""
    def const_of(name):
        val = None
        for p in op.block.ops:
            if name not in p.output_arg_names:
                continue
            if p.type == "fill_constant" and not p.input("ValueTensor"):
                val = p.attr("value")
            else:
                return None
        return val

    vals = [const_of(op.input(slot)[0]) for slot in ("Start", "End", "Step")]
    if any(v is None for v in vals):
        return
    n = len(np.arange(vals[0], vals[1], vals[2]))
    op.attrs["_folded_range"] = [float(v) for v in vals]
    dv = op.block._var_recursive(op.input("Start")[0])
    _mk_out(op, (n,), dv.dtype if dv is not None else "int64")


@register("range", grad=None, infer_shape=_range_infer,
          attrs={"_folded_range": []})
def _range(ctx, ins, attrs):
    sv = x(ins, "Start")
    s, e, st = (float(x(ins, k).reshape(())) for k in ("Start", "End",
                                                        "Step"))
    return out(torch.arange(s, e, st, device=sv.device).to(sv.dtype))


def _cast_infer(op):
    v = op.invar("X")
    if v is None:
        return
    _mk_out(op, v.shape, op.attr("out_dtype", "float32"))


@register("cast", infer_shape=_cast_infer,
          attrs={"in_dtype": "float32", "out_dtype": "float32"})
def _cast(ctx, ins, attrs):
    return out(x(ins).to(torch_dtype(attrs["out_dtype"])))


# ---------------------------------------------------------------------------
# search / sort (the index outputs are ints, without gradient)
# ---------------------------------------------------------------------------

def _argminmax_infer(op):
    v = op.invar("X")
    if v is None or v.shape is None:
        return
    ax = op.attr("axis", -1) % len(v.shape)
    shape = list(v.shape)
    if op.attr("keepdims", False):
        shape[ax] = 1
    else:
        shape.pop(ax)
    _mk_out(op, shape, op.attr("dtype", "int64"))


def _argminmax(fn):
    def compute(ctx, ins, attrs):
        v = x(ins)
        if attrs.get("flatten"):
            v = v.reshape(-1)
        r = fn(v, dim=attrs["axis"], keepdim=attrs.get("keepdims", False))
        return out(r.to(torch_dtype(attrs.get("dtype", "int64"))))
    return compute


_ARG_ATTRS = {"axis": -1, "keepdims": False, "dtype": "int64",
              "flatten": False}
register("arg_max", _argminmax(torch.argmax), grad=None,
         infer_shape=_argminmax_infer, attrs=dict(_ARG_ATTRS))
register("arg_min", _argminmax(torch.argmin), grad=None,
         infer_shape=_argminmax_infer, attrs=dict(_ARG_ATTRS))


def _argsort_infer(op):
    v = op.invar("X")
    if v is None or v.shape is None:
        return
    _mk_out(op, v.shape, v.dtype)
    _mk_out(op, v.shape, "int64", slot="Indices")


@register("argsort", grad=None, attrs={"axis": -1, "descending": False},
          infer_shape=_argsort_infer)
def _argsort(ctx, ins, attrs):
    v = x(ins)
    ax = attrs["axis"]
    idx = torch.argsort(-v if attrs["descending"] else v, dim=ax,
                        stable=True)
    return {"Out": [torch.gather(v, ax, idx)], "Indices": [idx.long()]}


def _topk_infer(op):
    v = op.invar("X")
    if v is None or v.shape is None:
        return
    ax = op.attr("axis", -1) % len(v.shape)
    shape = list(v.shape)
    shape[ax] = op.attr("k", 1)
    _mk_out(op, shape, v.dtype)
    _mk_out(op, shape, "int64", slot="Indices")


def _topk(ctx, ins, attrs):
    v = x(ins)
    kt = x(ins, "K")
    k = int(kt.reshape(-1)[0]) if kt is not None else attrs.get("k", 1)
    vals, idx = torch.topk(v, k, dim=attrs.get("axis", -1),
                           largest=attrs.get("largest", True) is not False,
                           sorted=True)
    return {"Out": [vals], "Indices": [idx]}


register("top_k", _topk, infer_shape=_topk_infer,
         attrs={"k": 1, "axis": -1, "largest": True},
         no_grad_out_slots=("Indices",))
register("top_k_v2", _topk, infer_shape=_topk_infer,
         attrs={"k": 1, "axis": -1, "largest": True, "sorted": True},
         no_grad_out_slots=("Indices",))


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------

register("flip", lambda ctx, ins, attrs: out(
    torch.flip(x(ins), tuple(attrs["axis"]))),
    attrs={"axis": []}, infer_shape=same_shape_as("X"))


@register("roll", attrs={"shifts": [], "axis": []},
          infer_shape=same_shape_as("X"))
def _roll(ctx, ins, attrs):
    v = x(ins)
    ax = attrs.get("axis") or None
    if ax is None:
        return out(torch.roll(v.reshape(-1), list(attrs["shifts"]))
                   .reshape(v.shape))
    return out(torch.roll(v, list(attrs["shifts"]), list(ax)))


@register("tril_triu", attrs={"diagonal": 0, "lower": True},
          infer_shape=same_shape_as("X"))
def _tril_triu(ctx, ins, attrs):
    v, d = x(ins), attrs.get("diagonal", 0)
    return out(torch.tril(v, d) if attrs.get("lower", True)
               else torch.triu(v, d))


def _meshgrid_infer(op):
    vs = [op.block._var_recursive(n) for n in op.input("X")]
    if any(v is None or v.shape is None for v in vs):
        return
    shape = tuple(v.shape[0] for v in vs)
    for n in op.output("Out"):
        op.block.create_var(name=n, shape=shape, dtype=vs[0].dtype)


register("meshgrid", lambda ctx, ins, attrs: {
    "Out": list(torch.meshgrid(*ins["X"], indexing="ij"))},
    infer_shape=_meshgrid_infer)


def _kron_infer(op):
    a, b = op.invar("X"), op.invar("Y")
    if None in (a, b) or a.shape is None or b.shape is None:
        return
    sa = [1] * (len(b.shape) - len(a.shape)) + list(a.shape)
    sb = [1] * (len(a.shape) - len(b.shape)) + list(b.shape)
    _mk_out(op, [i * j if i >= 0 and j >= 0 else -1
                 for i, j in zip(sa, sb)], a.dtype)


register("kron", lambda ctx, ins, attrs: out(
    torch.kron(x(ins, "X"), x(ins, "Y"))), infer_shape=_kron_infer)


@register("diag_v2", attrs={"offset": 0, "padding_value": 0.0})
def _diag_v2(ctx, ins, attrs):
    v, k = x(ins), attrs["offset"]
    if v.dim() == 1:
        r = torch.diag(v, k)
        pv = attrs.get("padding_value", 0.0)
        if pv:
            mask = torch.diag(torch.ones_like(v), k) > 0
            r = torch.where(mask, r, torch.full_like(r, pv))
        return out(r)
    return out(torch.diagonal(v, k))


@register("unique", grad=None, attrs={"dtype": "int64"})
def _unique(ctx, ins, attrs):
    v = x(ins)
    u, inv = torch.unique(v.reshape(-1), sorted=True, return_inverse=True)
    pad = v.numel() - u.numel()
    if pad:
        u = torch.cat([u, u[:1].expand(pad)])
    return {"Out": [u], "Index": [inv.long().reshape(v.shape)]}


@register("shard_index", grad=None,
          attrs={"index_num": 0, "nshards": 1, "shard_id": 0,
                 "ignore_value": -1})
def _shard_index(ctx, ins, attrs):
    v = x(ins)
    size = (attrs["index_num"] + attrs["nshards"] - 1) // attrs["nshards"]
    in_shard = torch.div(v, size, rounding_mode="floor") == attrs["shard_id"]
    return out(torch.where(in_shard, torch.remainder(v, size),
                           torch.full_like(v, attrs["ignore_value"])))


@register("increment", attrs={"step": 1.0})
def _increment(ctx, ins, attrs):
    return out(x(ins) + attrs["step"])

"""Tensor-building layers (counterpart of
``paddle_tpu/fluid/layers/tensor.py``): the functions of the reference's
``__all__`` whose ops are ported. Each appends ops through LayerHelper,
as the reference's. ``cond``, ``while_loop``, the tensor arrays and
StaticRNN wait for the sub-block executor (ROADMAP.md A, item 12).
"""
from __future__ import annotations

import builtins

import numpy as np

from .. import core
from ..framework import Variable, default_main_program
from ..layer_helper import LayerHelper

__all__ = [
    "data", "create_tensor", "create_parameter", "create_global_var", "cast",
    "concat", "sums", "assign", "fill_constant", "ones", "zeros",
    "ones_like", "zeros_like", "reshape", "transpose", "split", "stack",
    "squeeze", "unsqueeze", "expand", "gather", "scatter", "slice", "shape",
    "reduce_sum", "reduce_mean", "reduce_max", "reduce_min", "argmax",
    "argmin", "topk", "flatten", "mean", "mul", "elementwise_add",
    "elementwise_sub", "elementwise_mul", "elementwise_div",
    "elementwise_max", "elementwise_min", "elementwise_pow",
    "elementwise_mod", "elementwise_floordiv", "scale", "clip",
    "cross_entropy", "softmax_with_cross_entropy", "accuracy", "range",
    "increment", "equal", "less_than", "greater_than", "where",
]


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=False,
         type=None, stop_gradient=True):
    """Graph input (reference layers/io.py data / paddle.static.data).
    lod_level accepted for parity; ragged data must arrive dense+mask."""
    if append_batch_size:
        shape = [-1] + list(shape)
    block = default_main_program().global_block()
    return block.create_var(name=name, shape=shape, dtype=dtype, is_data=True,
                            stop_gradient=stop_gradient)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    helper = LayerHelper("create_parameter", name=name)
    from ..param_attr import ParamAttr
    attr = attr or ParamAttr(name=name)
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)


def sums(input, out=None):
    helper = LayerHelper("sum")
    if out is None:
        out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op(type="sum", inputs={"X": list(input)},
                     outputs={"Out": [out]})
    return out


def fill_constant(shape, dtype, value, force_cpu=False, out=None, name=None):
    helper = LayerHelper("fill_constant", name=name)
    if out is None:
        out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="fill_constant", outputs={"Out": [out]},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "value": float(value)})
    return out


def _reduce(name):
    def fn(input, dim=None, keep_dim=False, name_=None):
        if dim is None:
            attrs = {"dim": [0], "keep_dim": keep_dim, "reduce_all": True}
        else:
            d = dim if isinstance(dim, (list, tuple)) else [dim]
            attrs = {"dim": list(d), "keep_dim": keep_dim,
                     "reduce_all": False}
        return _op(name, name, {"X": [input]}, attrs)
    fn.__name__ = name
    return fn


reduce_sum = _reduce("reduce_sum")


def topk(input, k, name=None):
    helper = LayerHelper("top_k", name=name)
    values = helper.create_variable_for_type_inference(input.dtype)
    indices = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="top_k_v2", inputs={"X": [input]},
                     outputs={"Out": [values], "Indices": [indices]},
                     attrs={"k": k, "axis": -1})
    return values, indices


def flatten(x, axis=1, name=None):
    helper = LayerHelper("flatten2", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op(type="flatten2", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axis": axis})
    return out


def mean(x, name=None):
    return _op("mean", "mean", {"X": [x]})


def _elementwise(name):
    def fn(x, y, axis=-1, act=None, name_=None):
        helper = LayerHelper(name)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(type=name, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [out]}, attrs={"axis": axis})
        return helper.append_activation(out, act)
    fn.__name__ = name
    return fn


elementwise_add = _elementwise("elementwise_add")
elementwise_sub = _elementwise("elementwise_sub")
elementwise_mul = _elementwise("elementwise_mul")


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    helper = LayerHelper("softmax_with_cross_entropy")
    loss = helper.create_variable_for_type_inference(logits.dtype)
    softmax = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op(type="softmax_with_cross_entropy",
                     inputs={"Logits": [logits], "Label": [label]},
                     outputs={"Loss": [loss], "Softmax": [softmax]},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index, "axis": axis,
                            "numeric_stable_mode": numeric_stable_mode})
    if return_softmax:
        return loss, softmax
    return loss


def accuracy(input, label, k=1, correct=None, total=None):
    helper = LayerHelper("accuracy")
    values, indices = topk(input, k)
    acc = helper.create_variable_for_type_inference("float32")
    correct = correct or helper.create_variable_for_type_inference("int32")
    total = total or helper.create_variable_for_type_inference("int32")
    helper.append_op(type="accuracy",
                     inputs={"Out": [values], "Indices": [indices],
                             "Label": [label]},
                     outputs={"Accuracy": [acc], "Correct": [correct],
                              "Total": [total]})
    return acc


def _op(helper_name, op_type, inputs, attrs=None, dtype=None,
        out_slot="Out", name=None):
    """One op with one output (dtype inferred from the first input)."""
    helper = LayerHelper(helper_name, name=name)
    first = next(v[0] for v in inputs.values() if v)
    out = helper.create_variable_for_type_inference(
        dtype or (first.dtype if isinstance(first, Variable) else "float32"))
    helper.append_op(type=op_type, inputs=inputs, outputs={out_slot: [out]},
                     attrs=attrs or {})
    return out


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.main_program.current_block().create_var(
        name=name or helper.name, dtype=dtype, persistable=persistable)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    helper = LayerHelper("global_var", name=name)
    return helper.create_global_variable(name=name, shape=shape, dtype=dtype,
                                         persistable=persistable, value=value)


def cast(x, dtype):
    return _op("cast", "cast", {"X": [x]},
                          {"in_dtype": x.dtype,
                           "out_dtype": core.convert_dtype(dtype)},
                          dtype=dtype)


def concat(input, axis=0, name=None):
    return _op("concat", "concat", {"X": list(input)},
                          {"axis": axis})


def assign(input, output=None):
    helper = LayerHelper("assign")
    if isinstance(input, np.ndarray) or np.isscalar(input):
        arr = np.asarray(input)
        if output is None:
            output = helper.create_variable_for_type_inference(str(arr.dtype))
        attrs = {"shape": list(arr.shape) or [1], "dtype": str(arr.dtype)}
        if arr.dtype in (np.float32, np.float64):
            attrs["fp32_values"] = [float(v) for v in arr.flatten()]
        else:
            attrs["int64_values"] = [int(v) for v in arr.flatten()]
        helper.append_op(type="assign_value", outputs={"Out": [output]},
                         attrs=attrs)
        return output
    if output is None:
        output = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="assign", inputs={"X": [input]},
                     outputs={"Out": [output]})
    return output


def ones(shape, dtype="float32", force_cpu=False):
    return fill_constant(shape, dtype, 1.0)


def zeros(shape, dtype="float32", force_cpu=False):
    return fill_constant(shape, dtype, 0.0)


def ones_like(x, out=None):
    return _op("ones_like", "fill_any_like", {"X": [x]},
                          {"value": 1.0})


def zeros_like(x, out=None):
    return _op("zeros_like", "fill_zeros_like", {"X": [x]})


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    helper = LayerHelper("reshape2", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op(type="reshape2", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"shape": list(shape)})
    return helper.append_activation(out, act)


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose2", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op(type="transpose2", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axis": list(perm)})
    return out


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", name=name)
    if isinstance(num_or_sections, int):
        n, sections = num_or_sections, []
    else:
        n, sections = len(num_or_sections), list(num_or_sections)
    outs = [helper.create_variable_for_type_inference(input.dtype)
            for _ in builtins.range(n)]
    helper.append_op(type="split", inputs={"X": [input]},
                     outputs={"Out": outs},
                     attrs={"axis": dim, "num": n if not sections else 0,
                            "sections": sections})
    return outs


def stack(x, axis=0):
    helper = LayerHelper("stack")
    out = helper.create_variable_for_type_inference(x[0].dtype)
    helper.append_op(type="stack", inputs={"X": list(x)},
                     outputs={"Y": [out]}, attrs={"axis": axis})
    return out


def squeeze(input, axes, name=None):
    helper = LayerHelper("squeeze2", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    xshape = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op(type="squeeze2", inputs={"X": [input]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axes": list(axes)})
    return out


def unsqueeze(input, axes, name=None):
    helper = LayerHelper("unsqueeze2", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    xshape = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op(type="unsqueeze2", inputs={"X": [input]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axes": list(axes)})
    return out


def expand(x, expand_times, name=None):
    return _op("expand", "expand", {"X": [x]},
                          {"expand_times": list(expand_times)})


def gather(input, index, overwrite=True):
    return _op("gather", "gather",
                          {"X": [input], "Index": [index]})


def scatter(input, index, updates, name=None, overwrite=True):
    return _op("scatter", "scatter",
                          {"X": [input], "Ids": [index], "Updates": [updates]},
                          {"overwrite": overwrite})


def slice(input, axes, starts, ends):
    return _op("slice", "slice", {"Input": [input]},
                          {"axes": list(axes), "starts": list(starts),
                           "ends": list(ends)})


def shape(input):
    return _op("shape", "shape", {"Input": [input]},
                          dtype="int32")


reduce_mean = _reduce("reduce_mean")


reduce_max = _reduce("reduce_max")


reduce_min = _reduce("reduce_min")


def argmax(x, axis=0):
    return _op("arg_max", "arg_max", {"X": [x]}, {"axis": axis},
                          dtype="int64")


def argmin(x, axis=0):
    return _op("arg_min", "arg_min", {"X": [x]}, {"axis": axis},
                          dtype="int64")


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    return _op("mul", "mul", {"X": [x], "Y": [y]},
                          {"x_num_col_dims": x_num_col_dims,
                           "y_num_col_dims": y_num_col_dims})


elementwise_div = _elementwise("elementwise_div")


elementwise_max = _elementwise("elementwise_max")


elementwise_min = _elementwise("elementwise_min")


elementwise_pow = _elementwise("elementwise_pow")


elementwise_mod = _elementwise("elementwise_mod")


elementwise_floordiv = _elementwise("elementwise_floordiv")


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper("scale", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="scale", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"scale": scale, "bias": bias,
                            "bias_after_scale": bias_after_scale})
    return helper.append_activation(out, act)


def clip(x, min, max, name=None):
    return _op("clip", "clip", {"X": [x]},
                          {"min": float(min), "max": float(max)})


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    return _op("cross_entropy", "cross_entropy",
                          {"X": [input], "Label": [label]},
                          {"soft_label": soft_label,
                           "ignore_index": ignore_index}, out_slot="Y")


def range(start, end, step, dtype="int64"):
    helper = LayerHelper("range")
    if not isinstance(start, Variable):
        start = fill_constant([1], dtype, start)
    if not isinstance(end, Variable):
        end = fill_constant([1], dtype, end)
    if not isinstance(step, Variable):
        step = fill_constant([1], dtype, step)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="range",
                     inputs={"Start": [start], "End": [end], "Step": [step]},
                     outputs={"Out": [out]})
    return out


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="increment", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"step": float(value)})
    return out


def _cmp(name):
    def fn(x, y, cond=None):
        helper = LayerHelper(name)
        out = cond or helper.create_variable_for_type_inference("bool")
        helper.append_op(type=name, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [out]})
        return out
    fn.__name__ = name
    return fn


equal = _cmp("equal")


less_than = _cmp("less_than")


greater_than = _cmp("greater_than")


def where(condition, x, y):
    return _op("where", "where",
                          {"Condition": [condition], "X": [x], "Y": [y]})

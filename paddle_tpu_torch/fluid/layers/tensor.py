"""Tensor-building layers (counterpart of
``paddle_tpu/fluid/layers/tensor.py``): the functions the ported
programs use. Each appends ops through LayerHelper, as the reference's.
"""
from __future__ import annotations

from ..framework import default_main_program
from ..layer_helper import LayerHelper

__all__ = [
    "data", "create_parameter", "sums", "fill_constant", "reduce_sum",
    "topk", "flatten", "mean", "elementwise_add", "elementwise_sub",
    "elementwise_mul", "softmax_with_cross_entropy", "accuracy",
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


def _single_out_op(op_type, x, attrs=None):
    """One op of input X and output Out, Out taking X's dtype."""
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(x.dtype or "float32")
    helper.append_op(type=op_type, inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs=attrs or {})
    return out


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
        return _single_out_op(name, input, attrs)
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
    return _single_out_op("mean", x)


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

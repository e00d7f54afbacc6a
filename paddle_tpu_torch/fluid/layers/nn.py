"""Static-graph layer functions (counterpart of
``paddle_tpu/fluid/layers/nn.py``): fc, conv2d and pool2d, assembled
from ops through LayerHelper as in the reference.
"""
from __future__ import annotations

import math

from ..initializer import NormalInitializer
from ..layer_helper import LayerHelper

__all__ = ["fc", "conv2d", "pool2d"]


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """Fully-connected (reference layers/nn.py fc): mul + elementwise_add."""
    helper = LayerHelper("fc", input=input, size=size, act=act, name=name)
    dtype = input.dtype or "float32"
    in_shape = input.shape
    fan_in = math.prod(in_shape[num_flatten_dims:])
    w = helper.create_parameter(param_attr, shape=[fan_in, size], dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="mul", inputs={"X": [input], "Y": [w]},
                     outputs={"Out": [out]},
                     attrs={"x_num_col_dims": num_flatten_dims,
                            "y_num_col_dims": 1})
    b = helper.create_parameter(bias_attr, shape=[size], dtype=dtype,
                                is_bias=True)
    if b is not None:
        tmp = helper.create_variable_for_type_inference(dtype)
        helper.append_op(type="elementwise_add",
                         inputs={"X": [out], "Y": [b]},
                         outputs={"Out": [tmp]},
                         attrs={"axis": num_flatten_dims})
        out = tmp
    return helper.append_activation(out)


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None, data_format="NCHW"):
    helper = LayerHelper("conv2d", act=act, name=name)
    dtype = input.dtype or "float32"
    if isinstance(filter_size, int):
        filter_size = [filter_size, filter_size]
    if isinstance(stride, int):
        stride = [stride, stride]
    if isinstance(padding, int):
        padding = [padding, padding]
    if isinstance(dilation, int):
        dilation = [dilation, dilation]
    num_channels = input.shape[1]
    std = math.sqrt(2.0 / (filter_size[0] * filter_size[1] * num_channels))
    w = helper.create_parameter(
        param_attr,
        shape=[num_filters, num_channels // groups] + list(filter_size),
        dtype=dtype, default_initializer=NormalInitializer(0.0, std))
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="conv2d",
        inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [out]},
        attrs={"strides": stride, "paddings": padding, "dilations": dilation,
               "groups": groups, "data_format": data_format})
    b = helper.create_parameter(bias_attr, shape=[num_filters], dtype=dtype,
                                is_bias=True)
    if b is not None:
        tmp = helper.create_variable_for_type_inference(dtype)
        helper.append_op(type="elementwise_add",
                         inputs={"X": [out], "Y": [b]},
                         outputs={"Out": [tmp]}, attrs={"axis": 1})
        out = tmp
    return helper.append_activation(out)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, name=None, exclusive=True, data_format="NCHW"):
    helper = LayerHelper("pool2d", name=name)
    if isinstance(pool_size, int):
        pool_size = [pool_size, pool_size]
    if isinstance(pool_stride, int):
        pool_stride = [pool_stride, pool_stride]
    if isinstance(pool_padding, int):
        pool_padding = [pool_padding, pool_padding]
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="pool2d", inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"pooling_type": pool_type, "ksize": pool_size,
               "strides": pool_stride, "paddings": pool_padding,
               "global_pooling": global_pooling, "ceil_mode": ceil_mode,
               "exclusive": exclusive, "data_format": data_format})
    return out

"""Static-graph layer functions (counterpart of
``paddle_tpu/fluid/layers/nn.py``), assembled from ops through
LayerHelper as in the reference: the functions of its ``__all__`` whose
ops are ported, the sequence, RNN, CTC, CRF, NCE and hierarchical
sigmoid layers among them. The reference's ``dynamic_gru`` /
``dynamic_lstm`` (``layers/parity.py``) and ``layers/detection.py`` wait
for the parity and detection op modules (ROADMAP.md A, item 11).
"""
from __future__ import annotations

import math

from ..initializer import (ConstantInitializer, NormalInitializer,
                           UniformInitializer)
from ..layer_helper import LayerHelper
from ..ops.sequence_ops import rnn_weight_shapes

__all__ = [
    "fc", "conv2d", "pool2d", "batch_norm", "layer_norm", "group_norm",
    "instance_norm", "embedding", "dropout", "relu", "softmax", "one_hot",
    "matmul", "label_smooth", "clip_by_norm", "l2_normalize", "pad", "pad2d",
    "sequence_mask", "sequence_pad", "sequence_unpad", "sequence_pool",
    "sequence_softmax", "sequence_reverse", "sequence_expand",
    "segment_pool", "dynamic_rnn", "warpctc", "linear_chain_crf",
    "crf_decoding", "nce", "hsigmoid", "conv3d", "pool3d",
]


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


def _unary(op_type):
    def fn(x, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(type=op_type, inputs={"X": [x]},
                         outputs={"Out": [out]})
        return out
    fn.__name__ = op_type
    return fn


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               name=None, moving_mean_name=None, moving_variance_name=None,
               do_model_average_for_mean_and_var=True,
               use_global_stats=False):
    helper = LayerHelper("batch_norm", act=act, name=name)
    dtype = input.dtype or "float32"
    caxis = 1 if data_layout == "NCHW" else len(input.shape) - 1
    c = input.shape[caxis]
    scale = helper.create_parameter(
        param_attr, shape=[c], dtype=dtype,
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(bias_attr, shape=[c], dtype=dtype,
                                   is_bias=True)
    mean = helper.create_global_variable(
        name=moving_mean_name, shape=[c], dtype="float32", persistable=True,
        value=0.0)
    variance = helper.create_global_variable(
        name=moving_variance_name, shape=[c], dtype="float32",
        persistable=True, value=1.0)
    y = helper.create_variable_for_type_inference(dtype)
    saved_mean = helper.create_variable_for_type_inference("float32", True)
    saved_var = helper.create_variable_for_type_inference("float32", True)
    helper.append_op(
        type="batch_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias],
                "Mean": [mean], "Variance": [variance]},
        outputs={"Y": [y], "MeanOut": [mean], "VarianceOut": [variance],
                 "SavedMean": [saved_mean], "SavedVariance": [saved_var]},
        attrs={"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
               "data_layout": data_layout,
               "use_global_stats": use_global_stats})
    return helper.append_activation(y)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", act=act, name=name)
    dtype = input.dtype or "float32"
    feat = math.prod(input.shape[begin_norm_axis:])
    inputs = {"X": [input]}
    if scale:
        s = helper.create_parameter(
            param_attr, shape=[feat], dtype=dtype,
            default_initializer=ConstantInitializer(1.0))
        inputs["Scale"] = [s]
    if shift:
        b = helper.create_parameter(bias_attr, shape=[feat], dtype=dtype,
                                    is_bias=True)
        inputs["Bias"] = [b]
    y = helper.create_variable_for_type_inference(dtype)
    mean = helper.create_variable_for_type_inference("float32", True)
    var = helper.create_variable_for_type_inference("float32", True)
    helper.append_op(type="layer_norm", inputs=inputs,
                     outputs={"Y": [y], "Mean": [mean], "Variance": [var]},
                     attrs={"epsilon": epsilon,
                            "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(y)


def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None,
               act=None, data_layout="NCHW", name=None):
    helper = LayerHelper("group_norm", act=act, name=name)
    dtype = input.dtype or "float32"
    c = input.shape[1]
    inputs = {"X": [input]}
    s = helper.create_parameter(param_attr, shape=[c], dtype=dtype,
                                default_initializer=ConstantInitializer(1.0))
    b = helper.create_parameter(bias_attr, shape=[c], dtype=dtype,
                                is_bias=True)
    if s is not None:
        inputs["Scale"] = [s]
    if b is not None:
        inputs["Bias"] = [b]
    y = helper.create_variable_for_type_inference(dtype)
    mean = helper.create_variable_for_type_inference("float32", True)
    var = helper.create_variable_for_type_inference("float32", True)
    helper.append_op(type="group_norm", inputs=inputs,
                     outputs={"Y": [y], "Mean": [mean], "Variance": [var]},
                     attrs={"epsilon": epsilon, "groups": groups,
                            "data_layout": data_layout})
    return helper.append_activation(y)


def instance_norm(input, epsilon=1e-5, param_attr=None, bias_attr=None,
                  name=None):
    helper = LayerHelper("instance_norm", name=name)
    dtype = input.dtype or "float32"
    c = input.shape[1]
    s = helper.create_parameter(param_attr, shape=[c], dtype=dtype,
                                default_initializer=ConstantInitializer(1.0))
    b = helper.create_parameter(bias_attr, shape=[c], dtype=dtype,
                                is_bias=True)
    inputs = {"X": [input]}
    if s is not None:
        inputs["Scale"] = [s]
    if b is not None:
        inputs["Bias"] = [b]
    y = helper.create_variable_for_type_inference(dtype)
    sm = helper.create_variable_for_type_inference("float32", True)
    sv = helper.create_variable_for_type_inference("float32", True)
    helper.append_op(type="instance_norm", inputs=inputs,
                     outputs={"Y": [y], "SavedMean": [sm],
                              "SavedVariance": [sv]},
                     attrs={"epsilon": epsilon})
    return y


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    helper = LayerHelper("embedding")
    w = helper.create_parameter(param_attr, shape=list(size), dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="lookup_table_v2", inputs={"Ids": [input], "W": [w]},
        outputs={"Out": [out]},
        attrs={"padding_idx": -1 if padding_idx is None else padding_idx,
               "is_sparse": is_sparse, "is_distributed": is_distributed})
    return out


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    mask = helper.create_variable_for_type_inference("uint8", True)
    helper.append_op(type="dropout", inputs={"X": [x]},
                     outputs={"Out": [out], "Mask": [mask]},
                     attrs={"dropout_prob": dropout_prob, "is_test": is_test,
                            "fix_seed": seed is not None, "seed": seed or 0,
                            "dropout_implementation": dropout_implementation})
    return out


relu = _unary("relu")


def softmax(input, axis=-1, name=None, use_cudnn=False):
    helper = LayerHelper("softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="softmax", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def one_hot(input, depth, allow_out_of_range=False):
    helper = LayerHelper("one_hot")
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op(type="one_hot_v2", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"depth": depth,
                            "allow_out_of_range": allow_out_of_range})
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="matmul", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"transpose_X": transpose_x,
                            "transpose_Y": transpose_y, "alpha": alpha})
    return out


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32",
                 name=None):
    helper = LayerHelper("label_smooth", name=name)
    out = helper.create_variable_for_type_inference(dtype)
    inputs = {"X": [label]}
    if prior_dist is not None:
        inputs["PriorDist"] = [prior_dist]
    helper.append_op(type="label_smooth", inputs=inputs,
                     outputs={"Out": [out]}, attrs={"epsilon": epsilon})
    return out


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper("clip_by_norm", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="clip_by_norm", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"max_norm": max_norm})
    return out


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    helper = LayerHelper("l2_normalize", name=name)
    sq = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="square", inputs={"X": [x]}, outputs={"Out": [sq]})
    ssum = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="reduce_sum", inputs={"X": [sq]},
                     outputs={"Out": [ssum]},
                     attrs={"dim": [axis], "keep_dim": True,
                            "reduce_all": False})
    rs = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="rsqrt", inputs={"X": [ssum]},
                     outputs={"Out": [rs]})
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="elementwise_mul", inputs={"X": [x], "Y": [rs]},
                     outputs={"Out": [out]}, attrs={"axis": -1})
    return out


def pad(x, paddings, pad_value=0.0, name=None):
    helper = LayerHelper("pad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="pad", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"paddings": paddings, "pad_value": pad_value})
    return out


def pad2d(input, paddings=(0, 0, 0, 0), mode="constant", pad_value=0.0,
          data_format="NCHW", name=None):
    helper = LayerHelper("pad2d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="pad2d", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"paddings": list(paddings), "mode": mode,
                            "pad_value": pad_value,
                            "data_format": data_format})
    return out


# ---------------------------------------------------------------------------
# sequence, RNN and structured-loss layers (the LoD-free design: dense
# [B, T, ...] with lengths)
# ---------------------------------------------------------------------------

def _seq_op(type, inputs, attrs, dtype, n_out=1):
    helper = LayerHelper(type)
    outs = [helper.create_variable_for_type_inference(dtype)
            for _ in range(n_out)]
    outputs = {"Out": [outs[0]]}
    if n_out > 1:
        outputs["Length"] = [outs[1]]
    helper.append_op(type=type, inputs=inputs, outputs=outputs, attrs=attrs)
    return outs[0] if n_out == 1 else tuple(outs)


def sequence_mask(x, maxlen=-1, dtype="int64", name=None):
    """lengths [..] -> mask [.., maxlen] (maxlen -1: the longest)."""
    helper = LayerHelper("sequence_mask", name=name)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="sequence_mask", inputs={"X": [x]},
                     outputs={"Y": [out]},
                     attrs={"maxlen": maxlen if maxlen else -1,
                            "out_dtype": dtype})
    return out


def sequence_pad(x, pad_value=0.0, length=None, maxlen=-1, name=None):
    if length is None:
        raise ValueError(
            "sequence_pad needs `length` (per-sequence lengths): the "
            "flat-rows input carries no LoD")
    return _seq_op("sequence_pad",
                   {"X": [x], "Length": [length]},
                   {"padded_length": maxlen, "pad_value": pad_value},
                   x.dtype, n_out=2)


def sequence_unpad(x, length, name=None):
    return _seq_op("sequence_unpad", {"X": [x], "Length": [length]}, {},
                   x.dtype)


def sequence_pool(input, pool_type="average", length=None, pad_value=0.0,
                  name=None):
    ins = {"X": [input]}
    if length is not None:
        ins["Length"] = [length]
    return _seq_op("sequence_pool", ins,
                   {"pooltype": pool_type.upper(), "pad_value": pad_value},
                   input.dtype)


def sequence_softmax(input, length=None, name=None):
    ins = {"X": [input]}
    if length is not None:
        ins["Length"] = [length]
    return _seq_op("sequence_softmax", ins, {}, input.dtype)


def sequence_reverse(x, length=None, name=None):
    ins = {"X": [x]}
    if length is not None:
        ins["Length"] = [length]
    return _seq_op("sequence_reverse", ins, {}, x.dtype)


def sequence_expand(x, ref_length, name=None):
    return _seq_op("sequence_expand",
                   {"X": [x], "RefLength": [ref_length]}, {}, x.dtype)


def segment_pool(data, segment_ids, pool_type="sum", num_segments=-1,
                 name=None):
    return _seq_op("segment_pool",
                   {"X": [data], "SegmentIds": [segment_ids]},
                   {"pooltype": pool_type.upper(),
                    "num_segments": num_segments}, data.dtype)


def dynamic_rnn(input, hidden_size, mode="LSTM", num_layers=1,
                is_bidirec=False, sequence_length=None, param_attr=None,
                name=None):
    """A multi-layer (bi)directional recurrent net over dense [B, T, D],
    the one `rnn` op, its weights uniform in +-1/sqrt(hidden_size).
    Returns (out [B, T, hidden_size * directions], final hidden)."""
    helper = LayerHelper("dynamic_rnn", name=name)
    dtype = input.dtype or "float32"
    D = input.shape[-1]
    ndir = 2 if is_bidirec else 1
    std = 1.0 / math.sqrt(hidden_size)
    weights = [helper.create_parameter(
        param_attr, shape=list(shape), dtype=dtype,
        default_initializer=UniformInitializer(-std, std))
        for shape in rnn_weight_shapes(mode, D, hidden_size, num_layers,
                                       ndir)]
    out = helper.create_variable_for_type_inference(dtype)
    h_n = helper.create_variable_for_type_inference(dtype)
    c_n = helper.create_variable_for_type_inference(dtype)
    ins = {"Input": [input], "WeightList": weights}
    if sequence_length is not None:
        ins["SequenceLength"] = [sequence_length]
    helper.append_op(type="rnn", inputs=ins,
                     outputs={"Out": [out], "State": [h_n, c_n]},
                     attrs={"mode": mode, "hidden_size": hidden_size,
                            "num_layers": num_layers,
                            "is_bidirec": is_bidirec, "dropout_prob": 0.0})
    return out, h_n


def warpctc(input, label, blank=0, norm_by_times=False,
            input_length=None, label_length=None):
    """CTC loss on padded-dense inputs: input [B, T, C] raw logits,
    label [B, L], lengths [B]. Returns the [B, 1] loss."""
    helper = LayerHelper("warpctc")
    loss = helper.create_variable_for_type_inference("float32")
    grad = helper.create_variable_for_type_inference("float32", True)
    ins = {"Logits": [input], "Label": [label]}
    if input_length is not None:
        ins["LogitsLength"] = [input_length]
    if label_length is not None:
        ins["LabelLength"] = [label_length]
    helper.append_op(type="warpctc", inputs=ins,
                     outputs={"Loss": [loss], "WarpCTCGrad": [grad]},
                     attrs={"blank": blank, "norm_by_times": norm_by_times})
    return loss


def linear_chain_crf(input, label, param_attr=None, length=None):
    """The linear-chain CRF: creates the [num_tags+2, num_tags]
    transition parameter; returns the log likelihood [B, 1]."""
    helper = LayerHelper("linear_chain_crf")
    num_tags = input.shape[-1]
    trans = helper.create_parameter(
        param_attr, shape=[num_tags + 2, num_tags], dtype="float32")
    ll = helper.create_variable_for_type_inference("float32")
    alpha = helper.create_variable_for_type_inference("float32", True)
    ee = helper.create_variable_for_type_inference("float32", True)
    te = helper.create_variable_for_type_inference("float32", True)
    ins = {"Emission": [input], "Transition": [trans], "Label": [label]}
    if length is not None:
        ins["Length"] = [length]
    helper.append_op(
        type="linear_chain_crf", inputs=ins,
        outputs={"LogLikelihood": [ll], "Alpha": [alpha],
                 "EmissionExps": [ee], "TransitionExps": [te]},
        attrs={})
    return ll


def crf_decoding(input, param_attr=None, label=None, length=None,
                 transition=None):
    """The Viterbi path [B, T]. Pass `transition` to decode with the
    training CRF's parameter."""
    helper = LayerHelper("crf_decoding")
    if transition is None:
        num_tags = input.shape[-1]
        transition = helper.create_parameter(
            param_attr, shape=[num_tags + 2, num_tags], dtype="float32")
    path = helper.create_variable_for_type_inference("int64")
    ins = {"Emission": [input], "Transition": [transition]}
    if length is not None:
        ins["Length"] = [length]
    helper.append_op(type="crf_decoding", inputs=ins,
                     outputs={"ViterbiPath": [path]}, attrs={})
    return path


def nce(input, label, num_total_classes, sample_weight=None,
        param_attr=None, bias_attr=None, num_neg_samples=10, name=None,
        sampler="uniform", custom_dist=None, seed=0, is_sparse=False):
    """Noise-contrastive estimation: the [B, 1] cost."""
    helper = LayerHelper("nce", name=name)
    dim = input.shape[-1]
    w = helper.create_parameter(param_attr,
                                shape=[num_total_classes, dim],
                                dtype="float32")
    b = helper.create_parameter(bias_attr, shape=[num_total_classes],
                                dtype="float32", is_bias=True)
    cost = helper.create_variable_for_type_inference("float32")
    slog = helper.create_variable_for_type_inference("float32", True)
    slab = helper.create_variable_for_type_inference("int64", True)
    ins = {"Input": [input], "Label": [label], "Weight": [w]}
    if b is not None:
        ins["Bias"] = [b]
    helper.append_op(
        type="nce", inputs=ins,
        outputs={"Cost": [cost], "SampleLogits": [slog],
                 "SampleLabels": [slab]},
        attrs={"num_total_classes": num_total_classes,
               "num_neg_samples": num_neg_samples,
               "sampler": {"uniform": 0, "log_uniform": 1}.get(sampler, 0),
               "seed": seed, "is_sparse": is_sparse})
    return cost


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None, is_sparse=False):
    """Hierarchical sigmoid over the default complete binary tree: the
    [B, 1] cost."""
    helper = LayerHelper("hierarchical_sigmoid", name=name)
    dim = input.shape[-1]
    w = helper.create_parameter(param_attr, shape=[num_classes - 1, dim],
                                dtype="float32")
    b = helper.create_parameter(bias_attr, shape=[num_classes - 1],
                                dtype="float32", is_bias=True)
    cost = helper.create_variable_for_type_inference("float32")
    pre = helper.create_variable_for_type_inference("float32", True)
    wo = helper.create_variable_for_type_inference("float32", True)
    ins = {"X": [input], "Label": [label], "W": [w]}
    if b is not None:
        ins["Bias"] = [b]
    helper.append_op(type="hierarchical_sigmoid", inputs=ins,
                     outputs={"Out": [cost], "PreOut": [pre],
                              "W_Out": [wo]},
                     attrs={"num_classes": num_classes,
                            "is_sparse": is_sparse})
    return cost


def conv3d(input, num_filters, filter_size, stride=1, padding=0,
           dilation=1, groups=1, param_attr=None, bias_attr=None,
           use_cudnn=True, act=None, name=None, data_format="NCDHW"):
    """3D convolution, NCDHW (reference layers/nn.py conv3d)."""
    helper = LayerHelper("conv3d", act=act, name=name)
    dtype = input.dtype or "float32"
    to3 = lambda v: [v] * 3 if isinstance(v, int) else list(v)
    filter_size, stride = to3(filter_size), to3(stride)
    padding, dilation = to3(padding), to3(dilation)
    num_channels = input.shape[1]
    std = math.sqrt(2.0 / (filter_size[0] * filter_size[1]
                           * filter_size[2] * num_channels))
    w = helper.create_parameter(
        param_attr,
        shape=[num_filters, num_channels // groups] + filter_size,
        dtype=dtype, default_initializer=NormalInitializer(0.0, std))
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="conv3d", inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [out]},
        attrs={"strides": stride, "paddings": padding,
               "dilations": dilation, "groups": groups,
               "data_format": data_format})
    b = helper.create_parameter(bias_attr, shape=[num_filters],
                                dtype=dtype, is_bias=True)
    if b is not None:
        tmp = helper.create_variable_for_type_inference(dtype)
        helper.append_op(type="elementwise_add",
                         inputs={"X": [out], "Y": [b]},
                         outputs={"Out": [tmp]}, attrs={"axis": 1})
        out = tmp
    return helper.append_activation(out)


def pool3d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, name=None, exclusive=True,
           data_format="NCDHW"):
    """3D pooling, NCDHW (reference layers/nn.py pool3d)."""
    helper = LayerHelper("pool3d", name=name)
    to3 = lambda v: [v] * 3 if isinstance(v, int) else list(v)
    out = helper.create_variable_for_type_inference(
        input.dtype or "float32")
    helper.append_op(
        type="pool3d", inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"pooling_type": pool_type, "ksize": to3(pool_size),
               "strides": to3(pool_stride), "paddings": to3(pool_padding),
               "global_pooling": global_pooling, "ceil_mode": ceil_mode,
               "exclusive": exclusive, "data_format": data_format})
    return out


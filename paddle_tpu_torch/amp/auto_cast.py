"""Autocast by op type (counterpart of ``paddle_tpu/amp/auto_cast.py``).

The reference's tracer consults two lists per op and casts the op's
float inputs: white-list ops run in bfloat16, black-list ops in float32,
and every other op takes its inputs as they come (level O1) or in
bfloat16 (level O2). The port has no tracer: its functional ops
(``nn/functional.py``) call ``autocast_inputs(op_type, *tensors)``
themselves, under the level that ``amp_guard`` set. Gradients flow
through the casts (``Tensor.to`` is differentiable), as they do through
the reference's.

What level O1 does to the ops of the BERT step (read off the reference
op by op): ``matmul_v2`` and ``fused_attention`` are white, so every
linear's product and the attention run on bfloat16 inputs;
``layer_norm`` and ``softmax_with_cross_entropy`` are black;
``elementwise_add`` (a linear's bias), ``gelu``, ``tanh``, ``dropout``
and the block ops ``fused_out_ln``, ``fused_ffn_block`` and
``fused_dropout_add_ln`` are on neither list, so a linear's bfloat16
product plus its float32 bias is float32 again, ``fused_out_ln`` sees a
bfloat16 X beside float32 weights and residual, and ``fused_ffn_block``
runs in float32 throughout.

``batch_norm`` is on neither list: under O1 its X arrives as the
producing convolution left it (bfloat16) and Y comes back in X's type,
while the statistics are float32 inside the op. Under O2 only X is cast:
the op's Mean, Variance, Scale and Bias slots stay float32
(``_KEEP_F32_SLOTS``), as the reference keeps them.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["white_list", "black_list", "amp_guard", "auto_cast",
           "amp_level", "autocast_inputs"]

# ops that run in bfloat16 (the reference's white list)
white_list = {
    "matmul", "matmul_v2", "mul", "bmm", "conv2d", "depthwise_conv2d",
    "fc", "addmm", "fused_attention",
}
# numerically sensitive ops kept in float32 (the reference's black list)
black_list = {
    "softmax", "log_softmax", "cross_entropy", "softmax_with_cross_entropy",
    "layer_norm", "group_norm", "instance_norm", "mean",
    "reduce_mean", "reduce_sum", "sum", "exp", "log", "square", "sqrt",
    "rsqrt", "p_norm", "squared_l2_norm",
}

# slots that stay float32 when the op itself runs in bfloat16: batch
# norm's running statistics and affine parameters are float32 state
_KEEP_F32_SLOTS = {
    "batch_norm": {"Mean", "Variance", "Scale", "Bias"},
    "sync_batch_norm": {"Mean", "Variance", "Scale", "Bias"},
}

_level = 0   # 0 off, 1 "O1", 2 "O2"


def amp_level() -> int:
    return _level


def autocast_inputs(op_type: str, *tensors, slots=()):
    """The tensors as op `op_type` takes them under the current level:
    floating tensors cast to the list's type, everything else (None,
    integer tensors) untouched. `slots` names the op's input slot of
    each tensor where some must keep float32 (``_KEEP_F32_SLOTS``)."""
    if _level == 0:
        return tensors
    if op_type in white_list:
        target = torch.bfloat16
    elif op_type in black_list:
        target = torch.float32
    elif _level == 2:
        target = torch.bfloat16
    else:
        return tensors
    keep = _KEEP_F32_SLOTS.get(op_type) if target == torch.bfloat16 \
        else None
    if keep and slots:
        return tuple(t if slot in keep else _cast(t, target)
                     for t, slot in zip(tensors, slots))
    return tuple(_cast(t, target) for t in tensors)


def _cast(t, target):
    return t.to(target) if t is not None and t.is_floating_point() \
        and t.dtype != target else t


@contextlib.contextmanager
def amp_guard(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1"):
    """Run the block under autocast level "O1" or "O2"; the custom lists
    extend the module's for the block only."""
    global _level
    if level not in ("O1", "O2"):
        raise ValueError(f"amp level must be 'O1' or 'O2', got {level!r}")
    added_w = set(custom_white_list or []) - white_list
    added_b = set(custom_black_list or []) - black_list
    white_list.update(added_w)
    black_list.update(added_b)
    prev = _level
    _level = (1 if level == "O1" else 2) if enable else 0
    try:
        yield
    finally:
        _level = prev
        white_list.difference_update(added_w)
        black_list.difference_update(added_b)


auto_cast = amp_guard

"""Shared helpers for op compute/infer functions (counterpart of
``paddle_tpu/fluid/ops/common.py``)."""
from __future__ import annotations


def x(ins, slot="X"):
    v = ins.get(slot)
    return v[0] if v else None


def out(val, slot="Out"):
    return {slot: [val]}


def bcast_to_x(xv, yv, axis: int):
    """Paddle elementwise broadcast: align y's dims to x starting at `axis`
    (reference operators/elementwise/elementwise_op_function.h)."""
    if axis == -1 or xv.dim() == yv.dim():
        return yv
    axis = int(axis)
    new_shape = (1,) * axis + tuple(yv.shape) \
        + (1,) * (xv.dim() - axis - yv.dim())
    return yv.reshape(new_shape)


def static_reduce_shape(shape, dim, keep_dim, reduce_all):
    if shape is None:
        return None
    nd = len(shape)
    axes = set(range(nd)) if reduce_all or not dim else {d % nd for d in dim}
    if keep_dim:
        return tuple(1 if i in axes else s for i, s in enumerate(shape))
    kept = tuple(s for i, s in enumerate(shape) if i not in axes)
    return kept if kept else (1,)

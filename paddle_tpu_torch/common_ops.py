"""Dual-mode op invocation for the 2.0 functional API (counterpart of
``paddle_tpu/common_ops.py``).

In static mode an op is appended to the current Program through
LayerHelper, as in the reference. In dygraph mode the reference runs
the op through its tracer; the port rebuilds no tracer: the registered
compute runs at once on the given tensors and ``torch.autograd``
records it.
"""
from __future__ import annotations

import itertools

import torch

from .fluid.framework import in_dygraph_mode
from .fluid.layer_helper import LayerHelper

__all__ = ["run_op", "run_op_multi"]

_eager_rng_ids = itertools.count(1)


def _run_eager(op_type: str, inputs: dict, attrs: dict,
               stop_gradient: bool) -> dict:
    from .fluid import registry
    from .fluid.executor import ExecContext
    opdef = registry.require(op_type)
    attrs = dict(attrs)
    opdef.fill_default_attrs(attrs)
    if opdef.stochastic:
        attrs.setdefault("_rng_id", next(_eager_rng_ids))
    ins = _norm(inputs)
    device = next((v.device for vals in ins.values() for v in vals
                   if isinstance(v, torch.Tensor)), torch.device("cpu"))
    ctx = ExecContext(int(torch.randint(0, 2 ** 31, (1,))), device=device)
    with torch.set_grad_enabled(torch.is_grad_enabled()
                                and not stop_gradient):
        return opdef.compute(ctx, ins, attrs)


def run_op(op_type: str, inputs: dict, attrs: dict | None = None,
           out_slot: str = "Out", stop_gradient: bool = False):
    """Run/append one op, returning the tensor (or, in static mode, the
    Variable) of `out_slot`; the output takes the first input's dtype."""
    attrs = attrs or {}
    if in_dygraph_mode():
        return _run_eager(op_type, inputs, attrs, stop_gradient)[
            out_slot][0]
    helper = LayerHelper(op_type)
    dtype = None
    for lst in inputs.values():
        if lst:
            v0 = lst[0] if isinstance(lst, (list, tuple)) else lst
            dtype = getattr(v0, "dtype", None)
            if dtype:
                break
    out = helper.create_variable_for_type_inference(dtype or "float32")
    helper.append_op(type=op_type, inputs=_norm(inputs),
                     outputs={out_slot: [out]}, attrs=attrs)
    return out


def run_op_multi(op_type: str, inputs: dict, attrs: dict | None = None,
                 out_slots: dict | None = None, stop_gradient: bool = False):
    """Run/append one op with several output slots.

    out_slots: slot -> number of outputs (or dtype string for single output).
    Returns dict slot -> list of tensors.
    """
    attrs = attrs or {}
    if in_dygraph_mode():
        return _run_eager(op_type, inputs, attrs, stop_gradient)
    helper = LayerHelper(op_type)
    outputs = {}
    for slot, spec in (out_slots or {}).items():
        if isinstance(spec, int):
            outputs[slot] = [helper.create_variable_for_type_inference()
                             for _ in range(spec)]
        else:
            outputs[slot] = [helper.create_variable_for_type_inference(spec)]
    helper.append_op(type=op_type, inputs=_norm(inputs), outputs=outputs,
                     attrs=attrs)
    return outputs


def _norm(inputs: dict) -> dict:
    return {k: (list(v) if isinstance(v, (list, tuple)) else [v])
            for k, v in inputs.items() if v is not None}

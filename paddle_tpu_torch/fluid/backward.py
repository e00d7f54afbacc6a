"""Graph-level autodiff: append gradient ops to a Program (counterpart
of ``paddle_tpu/fluid/backward.py``).

Walk ops in reverse, ask each op's grad maker
(registry.make_default_grad_ops) to emit grad ops into the SAME block,
sum-accumulate fan-out gradients (`X@GRAD@RENAME@k` + a `sum` op),
honour stop_gradient/no_grad_set. Grad ops are emitted for every
differentiable ancestor of the loss, as the reference does.
"""
from __future__ import annotations

import warnings

from . import registry
from .framework import Variable, grad_var_name

__all__ = ["append_backward", "gradients"]


def _differentiable_ancestors(block, loss_name: str, no_grad: set[str]):
    """Vars that influence the loss through differentiable ops."""
    need = {loss_name}
    # iterate to fixpoint over reverse order (block is topologically ordered,
    # one reverse sweep suffices)
    for op in reversed(block.ops):
        if not any(n in need for n in op.output_arg_names):
            continue
        opdef = registry.lookup(op.type)
        if opdef is None or opdef.grad is None:
            continue
        for slot, names in op.inputs.items():
            if slot in opdef.no_grad_slots:
                continue
            for n in names:
                v = block._var_recursive(n)
                if v is not None and v.stop_gradient:
                    continue
                if n in no_grad:
                    continue
                need.add(n)
    return need


def append_backward(loss: Variable, parameter_list=None, no_grad_set=None,
                    callbacks=None, checkpoints=None):
    """Append grad ops for `loss`; returns [(param, grad_var)].

    `checkpoints` (recompute segments, the reference's checkpoint-aware
    backward) raise NotImplementedError: they come in a later PR of
    slice 4 (ROADMAP.md A, item 12)."""
    if checkpoints:
        raise NotImplementedError(
            "append_backward(checkpoints=...) (recompute segments) is not "
            "ported yet: it comes in a later PR of slice 4 (ROADMAP.md A, "
            "item 12)")
    block = loss.block
    program = block.program
    no_grad = set()
    for item in (no_grad_set or ()):
        no_grad.add(item.name if isinstance(item, Variable) else str(item))

    need = _differentiable_ancestors(block, loss.name, no_grad)

    loss_idx = max(i for i, op in enumerate(block.ops)
                   if loss.name in op.output_arg_names) \
        if any(loss.name in op.output_arg_names for op in block.ops) else \
        len(block.ops) - 1

    # Seed d(loss)/d(loss) = 1
    loss_grad = grad_var_name(loss.name)
    block.append_op(
        type="fill_constant",
        outputs={"Out": [loss_grad]},
        attrs={"shape": list(loss.shape or [1]), "value": 1.0,
               "dtype": loss.dtype or "float32"})
    written = {loss_grad: 1}

    def emit(type, inputs, outputs, attrs):
        # fan-out accumulation: second writer of X@GRAD gets renamed and summed
        renames = []
        new_outputs = {}
        for slot, names in outputs.items():
            fixed = []
            for n in names:
                if n == "@EMPTY@":  # pruned stop-gradient slot entry
                    fixed.append(n)
                    continue
                if n in written:
                    rn = f"{n}@RENAME@{written[n]}"
                    written[n] += 1
                    renames.append((n, rn))
                    fixed.append(rn)
                else:
                    written[n] = 1
                    fixed.append(n)
            new_outputs[slot] = fixed
        block.append_op(type=type, inputs=inputs, outputs=new_outputs,
                        attrs=attrs)
        for orig, rn in renames:
            block.append_op(type="sum", inputs={"X": [orig, rn]},
                            outputs={"Out": [orig]})

    def emit_grads_for(op):
        if not any(n in need for n in op.output_arg_names):
            return
        opdef = registry.lookup(op.type)
        if opdef is None or opdef.grad is None:
            return
        # zero-fill upstream grads that nothing produced (reference
        # fill_zeros_like insertion)
        for slot, names in op.outputs.items():
            if slot in opdef.no_grad_out_slots:
                continue
            for n in names:
                gn = grad_var_name(n)
                if gn not in written:
                    block.append_op(type="fill_zeros_like",
                                    inputs={"X": [n]}, outputs={"Out": [gn]})
                    written[gn] = 1
        if opdef.grad == "auto":
            registry.make_default_grad_ops(op, emit)
        else:
            opdef.grad(op, emit)

    for op in reversed(block.ops[: loss_idx + 1]):
        emit_grads_for(op)

    # collect (param, grad) pairs
    if parameter_list is not None:
        params = [block._var_recursive(p) if not isinstance(p, Variable) else p
                  for p in parameter_list]
    else:
        params = [p for p in program.all_parameters() if p.trainable]
    param_grads = []
    for p in params:
        gn = grad_var_name(p.name)
        if gn in written:
            gv = block._var_recursive(gn) or block.create_var(
                name=gn, shape=p.shape, dtype=p.dtype)
            param_grads.append((p, gv))
        elif p.name in no_grad or p.stop_gradient:
            continue
        else:
            warnings.warn(f"parameter {p.name} receives no gradient from "
                          f"{loss.name}")
    return param_grads


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """Static `paddle.static.gradients` (reference backward.py:1795).

    Multiple targets (optionally weighted by target_gradients) are combined
    into one scalar sum first so gradients through shared subgraphs
    accumulate correctly in a single backward pass.
    """
    from . import layers
    from .framework import program_guard
    targets = targets if isinstance(targets, (list, tuple)) else [targets]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    tgs = list(target_gradients) if target_gradients is not None \
        else [None] * len(targets)
    block = targets[0].block
    with program_guard(block.program):
        parts = []
        for t, tg in zip(targets, tgs):
            weighted = t if tg is None else layers.elementwise_mul(t, tg)
            parts.append(layers.reduce_sum(weighted))
        combined = parts[0] if len(parts) == 1 else layers.sums(parts)
    append_backward(combined, parameter_list=[], no_grad_set=no_grad_set)
    return [block._var_recursive(grad_var_name(v.name)) for v in inputs]

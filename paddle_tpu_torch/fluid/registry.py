"""Op registry: schema + shape inference + torch compute + autograd rules
(counterpart of ``paddle_tpu/fluid/registry.py``).

One registered ``OpDef`` bundles what the reference splits across
OpProtoAndCheckerMaker / InferShape / GradOpDescMaker / kernels:

  - attrs schema with defaults
  - infer_shape(op)                 (shape inference at append time)
  - compute(ctx, ins, attrs)        (the op on torch tensors; where the
                                     reference reaches a Pallas kernel it
                                     reaches the port's kernel wrapper)
  - grad maker                      (GradOpDescMaker equivalent)

Autograd: unless an op registers a grad maker, a generic `<type>_grad`
op is synthesised. Where the reference takes ``jax.vjp`` of the forward
compute, the port detaches the forward inputs, re-runs the forward
compute under ``torch.enable_grad()`` and calls ``torch.autograd.grad``:
the forward runs again inside every grad op (the reference's jit
deduplicates it; the port's op-by-op executor does not). Grad ops stay
real ops of the Program, as in the reference.

Only the ops of the slices ported so far are registered. Looking up any
other op raises ``NotImplementedError`` naming where it is queued.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

_REGISTRY: dict[str, "OpDef"] = {}

GRAD_SUFFIX = "@GRAD"
EMPTY_VAR = "@EMPTY@"

NOT_PORTED = (
    "op {!r} is not ported to paddle_tpu_torch yet: the math, tensor, nn, "
    "random, metric, optimizer, sequence, structured-loss, misc and tail op "
    "modules are; the parity (sync_batch_norm and yolov3_loss among them), "
    "detection and parameter-server op modules (82 op types) come in the "
    "last PR of ROADMAP.md A, item 11, and the control-flow ops (cond, "
    "while, recurrent) with the sub-block executor (item 12)")


@dataclasses.dataclass
class OpDef:
    type: str
    compute: Callable  # (ctx, ins: dict[str, list], attrs) -> dict[str, list]
    infer_shape: Callable | None = None
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)
    # grad maker: (op, emit) -> None, where emit(type, inputs, outputs, attrs)
    # appends a grad op. "auto" = synthesise by autograd; None =
    # non-differentiable (treated as stop_gradient).
    grad: Any = "auto"
    # fwd input slots that never receive gradient (indices, masks, seeds)
    no_grad_slots: tuple = ()
    # fwd *output* slots that are non-differentiable (e.g. argmax Indices)
    no_grad_out_slots: tuple = ()
    # whether the compute consumes randomness (gets a stable per-op rng id)
    stochastic: bool = False

    def fill_default_attrs(self, attrs: dict):
        for k, v in self.attrs.items():
            attrs.setdefault(k, v)


def register(type: str, compute=None, *, infer_shape=None, attrs=None,
             grad="auto", no_grad_slots=(), no_grad_out_slots=(),
             stochastic=False):
    """Register an op. Usable as a decorator on the compute fn."""
    def _do(fn):
        if type in _REGISTRY:
            raise ValueError(f"op {type!r} already registered")
        _REGISTRY[type] = OpDef(
            type=type, compute=fn, infer_shape=infer_shape,
            attrs=dict(attrs or {}), grad=grad,
            no_grad_slots=tuple(no_grad_slots),
            no_grad_out_slots=tuple(no_grad_out_slots),
            stochastic=stochastic)
        return fn
    if compute is not None:
        return _do(compute)
    return _do


def lookup(type: str) -> OpDef | None:
    op = _REGISTRY.get(type)
    if op is None and type.endswith("_grad"):
        # lazily synthesise the autograd grad ops
        fwd = _REGISTRY.get(type[: -len("_grad")])
        if fwd is not None and fwd.grad == "auto":
            op = _make_auto_grad_opdef(fwd)
            _REGISTRY[type] = op
    return op


def require(type: str) -> OpDef:
    op = lookup(type)
    if op is None:
        raise NotImplementedError(NOT_PORTED.format(type))
    return op


# ---------------------------------------------------------------------------
# autograd grad synthesis
# ---------------------------------------------------------------------------

def make_default_grad_ops(op, emit):
    """Default GradOpDescMaker: one `<type>_grad` op mirroring the fwd op.

    Grad-op slots:  fwd inputs keep their slot names; for each fwd output
    slot S a slot "S@GRAD" carries the upstream gradients; outputs are
    "S@GRAD" for each differentiable fwd input slot S.
    """
    opdef = require(op.type)
    inputs = {k: list(v) for k, v in op.inputs.items()}
    for slot, names in op.outputs.items():
        if slot in opdef.no_grad_out_slots:
            continue
        inputs[slot + GRAD_SUFFIX] = [n + GRAD_SUFFIX for n in names]
    outputs = {}
    for slot, names in op.inputs.items():
        if slot in opdef.no_grad_slots:
            continue
        grad_names = []
        any_live = False
        for n in names:
            v = op.block._var_recursive(n)
            if v is not None and v.stop_gradient:
                grad_names.append(EMPTY_VAR)  # pruned (stop_gradient)
            else:
                grad_names.append(n + GRAD_SUFFIX)
                any_live = True
        if any_live:
            outputs[slot + GRAD_SUFFIX] = grad_names
    attrs = {k: v for k, v in op.attrs.items()}
    emit(op.type + "_grad", inputs, outputs, attrs)


def _make_auto_grad_opdef(fwd: OpDef) -> OpDef:
    def grad_compute(ctx, ins, attrs):
        # split grad-op inputs back into fwd inputs vs upstream out-grads
        fwd_ins = {k: list(v) for k, v in ins.items()
                   if not k.endswith(GRAD_SUFFIX)}
        out_grads = {k[: -len(GRAD_SUFFIX)]: v
                     for k, v in ins.items() if k.endswith(GRAD_SUFFIX)}
        # differentiable leaves: floating tensors in non-excluded slots,
        # detached from whatever produced them
        diff_keys: list[tuple[str, int]] = []
        primals: list[torch.Tensor] = []
        for slot, vals in fwd_ins.items():
            if slot in fwd.no_grad_slots:
                continue
            for i, v in enumerate(vals):
                if isinstance(v, torch.Tensor) and v.is_floating_point():
                    p = v.detach().requires_grad_()
                    fwd_ins[slot][i] = p
                    diff_keys.append((slot, i))
                    primals.append(p)
        with torch.enable_grad():
            outs = fwd.compute(ctx, fwd_ins, attrs)
        # an output with no upstream gradient takes a zero cotangent,
        # which adds nothing: it is left out, as are outputs that carry
        # no graph (integer outputs, detached no-grad slots)
        flat, cts = [], []
        for slot in sorted(outs):
            g = out_grads.get(slot) or []
            for i, o in enumerate(outs[slot]):
                gv = g[i] if i < len(g) else None
                if gv is None or not isinstance(o, torch.Tensor) \
                        or not o.requires_grad:
                    continue
                flat.append(o)
                cts.append(gv.to(o.dtype).reshape(o.shape))
        grads = torch.autograd.grad(flat, primals, cts, allow_unused=True) \
            if flat and primals else [None] * len(primals)

        result: dict[str, list] = {}
        for slot, vals in fwd_ins.items():
            if slot in fwd.no_grad_slots:
                continue
            result[slot + GRAD_SUFFIX] = [None] * len(vals)
        for (slot, i), g, p in zip(diff_keys, grads, primals):
            # an input the outputs do not depend on gets zeros, as vjp
            # gives them
            result[slot + GRAD_SUFFIX][i] = \
                torch.zeros_like(p) if g is None else g.detach()
        return result

    def grad_infer_shape(op):
        # each input-grad has the shape/dtype of the corresponding fwd input
        block = op.block
        for slot, names in op.outputs.items():
            src = op.inputs.get(slot[: -len(GRAD_SUFFIX)], [])
            for name, src_name in zip(names, src):
                sv = block._var_recursive(src_name)
                if sv is not None:
                    block.create_var(name=name, shape=sv.shape, dtype=sv.dtype)

    return OpDef(type=fwd.type + "_grad", compute=grad_compute,
                 infer_shape=grad_infer_shape, attrs=dict(fwd.attrs),
                 grad=None, stochastic=False)


# ---------------------------------------------------------------------------
# shape-inference helpers shared by op definitions
# ---------------------------------------------------------------------------

def same_shape_as(in_slot: str, out_slot: str = "Out"):
    """Output mirrors shape+dtype of the (first) input in `in_slot`."""
    def _infer(op):
        v = op.invar(in_slot)
        if v is None:
            return
        for name in op.output(out_slot):
            op.block.create_var(name=name, shape=v.shape, dtype=v.dtype)
    return _infer


def elementwise_infer(op):
    x, y = op.invar("X"), op.invar("Y")
    shape, dtype = None, None
    if x is not None and x.shape is not None:
        shape, dtype = x.shape, x.dtype
    if y is not None and y.shape is not None and (
            shape is None or len(y.shape) > len(shape)):
        shape = y.shape
        dtype = dtype or y.dtype
    for name in op.output("Out"):
        op.block.create_var(name=name, shape=shape, dtype=dtype)

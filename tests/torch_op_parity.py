"""Parity harness of the port's op library against the JAX package's:
one op case (an ``op_test.OpCase``: op, numpy inputs, attrs) runs
through both registries on the CPU.

``check_outputs``: the op's compute on the same inputs in both packages
(the port on CPU tensors, the reference on jax arrays); every output
compared. ``check_grads``: in each package a static program (data vars
-> the op -> loss = the sum of each float output times a fixed random
projection) gets ``append_backward`` and one executor run; every input
gradient compared. Stated tolerances: f32 outputs rtol 1e-5 / atol
1e-6, gradients rtol 1e-4 / atol 1e-5."""
from __future__ import annotations

import numpy as np
import torch

import jax
import jax.numpy as jnp

import paddle_tpu
import paddle_tpu.distributed.collective  # noqa: F401  (the c_* ops)
import paddle_tpu.fluid.ops  # noqa: F401
import paddle_tpu.ops.flash_attention  # noqa: F401  (fused_attention)
import paddle_tpu.ops.paged_attention  # noqa: F401  (paged_attention)
import paddle_tpu_torch as pt
from paddle_tpu.fluid import backward as jbackward
from paddle_tpu.fluid import framework as jfw
from paddle_tpu.fluid import layers as jlayers
from paddle_tpu.fluid import registry as jreg
from paddle_tpu.fluid import unique_name as jun
from paddle_tpu.fluid.executor import ExecContext as JCtx
from paddle_tpu.fluid.executor import Executor as JExecutor
from paddle_tpu.fluid.scope import Scope as JScope
from paddle_tpu.fluid.scope import scope_guard as jscope_guard
from paddle_tpu_torch.fluid import CPUPlace
from paddle_tpu_torch.fluid import backward as tbackward
from paddle_tpu_torch.fluid import framework as tfw
from paddle_tpu_torch.fluid import layers as tlayers
from paddle_tpu_torch.fluid import registry as treg
from paddle_tpu_torch.fluid import unique_name as tun
from paddle_tpu_torch.fluid.executor import ExecContext as TCtx
from paddle_tpu_torch.fluid.executor import Executor as TExecutor
from paddle_tpu_torch.fluid.scope import Scope as TScope
from paddle_tpu_torch.fluid.scope import scope_guard as tscope_guard

OUT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


class _Pkg:
    def __init__(self, mod, fw, layers, backward, reg, un, executor, scope,
                 guard):
        self.mod, self.fw, self.layers = mod, fw, layers
        self.backward, self.reg, self.un = backward, reg, un
        self.executor, self.scope, self.guard = executor, scope, guard


JAX = _Pkg(paddle_tpu, jfw, jlayers, jbackward, jreg, jun, JExecutor,
           JScope, jscope_guard)
PORT = _Pkg(pt, tfw, tlayers, tbackward, treg, tun,
            lambda: TExecutor(CPUPlace()), TScope, tscope_guard)


def _as_list(v):
    return list(v) if isinstance(v, (list, tuple)) else [v]


def _np(v):
    if v is None:
        return None
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _attrs(reg, op, attrs):
    a = dict(attrs)
    reg.require(op).fill_default_attrs(a)
    if reg.require(op).stochastic:
        a.setdefault("_rng_id", 0)
    return a


def run_ref(op, inputs, attrs, is_test=False):
    ins = {s: [jnp.asarray(np.asarray(a)) for a in _as_list(v)]
           for s, v in inputs.items()}
    outs = jreg.require(op).compute(JCtx(jax.random.PRNGKey(0),
                                         is_test=is_test), ins,
                                    _attrs(jreg, op, attrs))
    return {s: [_np(v) for v in vals] for s, vals in outs.items()}


def run_port(op, inputs, attrs, is_test=False, seed=0):
    ins = {s: [torch.as_tensor(np.array(a, copy=True))
               for a in _as_list(v)] for s, v in inputs.items()}
    outs = treg.require(op).compute(TCtx(seed, is_test=is_test,
                                         device="cpu"), ins,
                                    _attrs(treg, op, attrs))
    return {s: [_np(v) for v in vals] for s, vals in outs.items()}


def check_outputs(case):
    """The op's outputs in both packages, compared slot by slot."""
    ref = run_ref(case.op, case.inputs, case.attrs)
    got = run_port(case.op, case.inputs, case.attrs)
    for slot, vals in ref.items():
        assert slot in got, f"{case.op}: no output {slot}"
        for i, (r, g) in enumerate(zip(vals, got[slot])):
            if r is None:
                continue
            assert g is not None, f"{case.op} {slot}[{i}]"
            assert tuple(np.shape(g)) == tuple(np.shape(r)), \
                f"{case.op} {slot}[{i}]: {np.shape(g)} vs {np.shape(r)}"
            np.testing.assert_allclose(
                np.asarray(g, np.float64), np.asarray(r, np.float64),
                err_msg=f"{case.op} output {slot}[{i}]", **OUT_TOL)


def _float_outs(pkg, op, probe):
    opdef = pkg.reg.require(op)
    return [(slot, i) for slot, vals in probe.items()
            if slot not in opdef.no_grad_out_slots
            for i, v in enumerate(vals)
            if v is not None and np.issubdtype(np.asarray(v).dtype,
                                               np.floating)]


def _grads(pkg, case, probe, grad_targets):
    """Input gradients of sum(out * R) through pkg's static graph."""
    pkg.mod.enable_static()
    try:
        main, startup = pkg.fw.Program(), pkg.fw.Program()
        rng = np.random.RandomState(7)
        feed = {}
        with pkg.fw.program_guard(main, startup), pkg.un.guard():
            block = main.global_block()
            in_names = {}
            for slot, arrs in case.inputs.items():
                names = []
                for i, a in enumerate(_as_list(arrs)):
                    a = np.asarray(a)
                    n = f"in_{slot}_{i}"
                    block.create_var(name=n, shape=tuple(a.shape),
                                     dtype=str(a.dtype))
                    names.append(n)
                    feed[n] = a
                in_names[slot] = names
            out_names = {}
            for slot, vals in probe.items():
                names = [f"out_{slot}_{i}" for i, v in enumerate(vals)
                         if v is not None]
                for n in names:
                    block.create_var(name=n)
                if names:
                    out_names[slot] = names
            block.append_op(type=case.op, inputs=in_names,
                            outputs=out_names, attrs=dict(case.attrs))
            parts = []
            for slot, i in _float_outs(pkg, case.op, probe):
                r = np.asarray(rng.randn(*np.shape(probe[slot][i])),
                               np.float32)
                rn = f"r_{slot}_{i}"
                block.create_var(name=rn, shape=r.shape, dtype="float32")
                feed[rn] = r
                m = pkg.layers.elementwise_mul(block.var(f"out_{slot}_{i}"),
                                               block.var(rn))
                parts.append(pkg.layers.reduce_sum(m))
            loss = parts[0]
            for p in parts[1:]:
                loss = pkg.layers.elementwise_add(loss, p)
            pkg.backward.append_backward(loss)
    finally:
        pkg.mod.disable_static()
    with pkg.guard(pkg.scope()):
        exe = pkg.executor()
        exe.run(startup)
        fetch = [f"in_{slot}_{i}@GRAD" for slot, i in grad_targets]
        return [np.asarray(g) for g in exe.run(main, feed=feed,
                                               fetch_list=fetch)]


def grad_targets(case):
    opdef = treg.require(case.op)
    out = []
    for slot, arrs in case.inputs.items():
        if slot in opdef.no_grad_slots:
            continue
        if case.grad_slots is not None and slot not in case.grad_slots:
            continue
        for i, a in enumerate(_as_list(arrs)):
            if np.issubdtype(np.asarray(a).dtype, np.floating):
                out.append((slot, i))
    return out


def check_grads(case):
    """Every input gradient through both packages' append_backward."""
    targets = grad_targets(case)
    assert targets, f"{case.op}: no differentiable input"
    probe = run_port(case.op, case.inputs, case.attrs)
    ref = _grads(JAX, case, run_ref(case.op, case.inputs, case.attrs),
                 targets)
    got = _grads(PORT, case, probe, targets)
    for (slot, i), r, g in zip(targets, ref, got):
        np.testing.assert_allclose(
            np.asarray(g, np.float64), np.asarray(r, np.float64),
            err_msg=f"{case.op}: gradient of {slot}[{i}]", **GRAD_TOL)


def differentiable(case) -> bool:
    opdef = treg.require(case.op)
    return opdef.grad is not None and not case.skip_grad


def module_ops(module: str) -> list[str]:
    """The non-grad ops the port registers from fluid/ops/<module>.py."""
    return sorted(k for k, d in treg._REGISTRY.items()
                  if not k.endswith("_grad")
                  and d.compute.__module__.endswith("." + module))

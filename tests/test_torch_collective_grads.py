"""The gradient of the max / min all-reduce (c_allreduce_max /
c_allreduce_min) in both packages: append_backward over a program that
holds one succeeds; run data-parallel over two ranks (the reference on
a two-device mesh, the port on two gloo processes) its grad op raises
NotImplementedError, since the reference's, jax.vjp of lax.pmax / pmin,
has no differentiation rule; over one rank both are the identity and
agree. Before the port's grad op the port pruned the gradient to
nothing."""
import os
import pickle
from types import SimpleNamespace

import numpy as np
import pytest

import jax

import paddle_tpu
import paddle_tpu.distributed.collective  # noqa: F401  (registers c_*)
import paddle_tpu_torch as pt
import torch_dp_workers as W
from paddle_tpu.fluid import Executor as JExecutor
from paddle_tpu.fluid import backward as jbackward
from paddle_tpu.fluid import framework as jfw
from paddle_tpu.fluid import layers as jlayers
from paddle_tpu.fluid import registry as jregistry
from paddle_tpu.fluid.executor import ExecContext as JExecContext
from paddle_tpu.fluid.scope import Scope as JScope
from paddle_tpu.fluid.scope import scope_guard as jscope_guard
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.fluid import (CPUPlace, Executor, Scope, backward,
                                    framework, layers, scope_guard)

JAX = SimpleNamespace(enable_static=paddle_tpu.enable_static,
                      disable_static=paddle_tpu.disable_static,
                      framework=jfw, layers=jlayers, backward=jbackward)
PORT = SimpleNamespace(enable_static=pt.enable_static,
                       disable_static=pt.disable_static,
                       framework=framework, layers=layers,
                       backward=backward)
X = np.arange(12, dtype=np.float32).reshape(4, 3) - 5.0


@pytest.fixture(scope="module")
def port_two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("minmax")
    spawn(W.run, args=("minmax_grads", str(out)), nprocs=2, timeout=60)
    res = []
    for r in range(2):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return res


@pytest.mark.parametrize("op", ["max", "min"])
def test_the_grad_op_raises_over_two_ranks_in_both(op, port_two_ranks):
    """The reference's grad op runs over a named axis of two devices
    (jax.pmap, axis "dp"); the port's inside a data-parallel run of the
    program on two gloo ranks."""
    main, _, _ = W.build_minmax_program(JAX, op)
    assert f"c_allreduce_{op}_grad" in [o.type for o in
                                        main.global_block().ops]
    grad = jregistry.require(f"c_allreduce_{op}_grad")
    attrs = dict(jregistry.require(f"c_allreduce_{op}").attrs,
                 axis_name="dp")

    def run(v, g):
        return grad.compute(JExecContext(jax.random.PRNGKey(0)),
                            {"X": [v], "Out@GRAD": [g]}, attrs)["X@GRAD"][0]

    with pytest.raises(NotImplementedError, match=f"'p{op}'"):
        jax.pmap(run, axis_name="dp", devices=jax.devices()[:2])(
            X[:2], np.ones((2, 3), np.float32))
    for res in port_two_ranks:
        assert res[op] is not None
        assert "max/min all-reduce has no gradient, as in the reference" \
            in res[op]


@pytest.mark.parametrize("op", ["max", "min"])
def test_over_one_rank_the_gradient_is_the_reference_s(op):
    grads = []
    for pkg, exe_fn, scope, guard in (
            (JAX, JExecutor, JScope, jscope_guard),
            (PORT, lambda: Executor(CPUPlace()), Scope, scope_guard)):
        main, startup, loss = W.build_minmax_program(pkg, op)
        assert f"c_allreduce_{op}_grad" in [o.type for o in
                                            main.global_block().ops]
        with guard(scope()):
            exe = exe_fn()
            exe.run(startup)
            g, = exe.run(main, feed={"x": X}, fetch_list=["w@GRAD"])
        grads.append(np.asarray(g))
    np.testing.assert_allclose(grads[1], grads[0], rtol=1e-6)
    np.testing.assert_allclose(grads[1], X.sum(0) / 12.0, rtol=1e-6)

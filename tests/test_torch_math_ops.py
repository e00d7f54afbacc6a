"""The port's math ops (paddle_tpu_torch/fluid/ops/math_ops.py) against
the JAX package's on the CPU: every op the module registers runs the
case of tests/test_op_sweep.py where that suite has one, or a case of
its own (both in tests/torch_op_cases.py), through both registries;
outputs and the static append_backward gradients are compared
(tolerances in tests/torch_op_parity.py)."""
import numpy as np
import pytest

import torch_op_parity as P
from torch_op_cases import MATH_OWN as OWN
from torch_op_cases import SWEEP

OPS = P.module_ops("math_ops")
CASES = {**{k: c for k, c in SWEEP.items() if c.op in OPS}, **OWN}


def test_the_case_module_holds_the_sweep_s_cases():
    """tests/torch_op_cases.py's copy of tests/test_op_sweep.py's cases
    (which chip_smoke.py reads without JAX) is the sweep's: same keys,
    ops, attrs and inputs."""
    from test_op_sweep import CASES as REF
    assert sorted(SWEEP) == sorted(REF)
    for k, c in REF.items():
        got = SWEEP[k]
        assert (got.op, got.attrs, sorted(got.inputs)) == \
            (c.op, c.attrs, sorted(c.inputs)), k
        for slot, v in c.inputs.items():
            for a, b in zip(P._as_list(got.inputs[slot]), P._as_list(v)):
                np.testing.assert_array_equal(a, b, err_msg=f"{k} {slot}")


def test_every_op_of_the_module_has_a_case():
    assert len(OPS) == 94
    assert set(OPS) <= {c.op for c in CASES.values()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_outputs_match_the_reference(name):
    P.check_outputs(CASES[name])


@pytest.mark.parametrize("name", sorted(
    k for k, c in CASES.items() if P.differentiable(c)))
def test_gradients_match_the_reference(name):
    P.check_grads(CASES[name])


# the non-grad ops the port registers outside fluid/ops: the c_*
# collectives, held over two gloo ranks by tests/test_torch_distributed.py
# and tests/test_torch_collective_grads.py
EXEMPT = {"barrier", "c_allgather", "c_allreduce_max", "c_allreduce_min",
          "c_allreduce_sum", "c_broadcast", "c_comm_init", "c_comm_init_all",
          "c_concat", "c_gen_nccl_id", "c_identity", "c_reducescatter",
          "c_split", "c_sync_calc_stream", "c_sync_comm_stream",
          "c_wait_calc_stream"}


def test_every_registered_op_has_a_case_or_an_exemption():
    """Every non-grad op of the port's registry has a parity case in
    tests/torch_op_cases.py (the random ops: RANDOM; nce: its cost on
    the reference's samples, tests/test_torch_structured_loss_ops.py)
    or is exempted above; the count is at least the 351 of the op
    library's two slices."""
    import paddle_tpu_torch.distributed.collective  # noqa: F401
    import torch_op_cases as C
    from paddle_tpu_torch.fluid import registry
    ops = {k for k in registry._REGISTRY if not k.endswith("_grad")}
    covered = {c.op for d in (C.SWEEP, C.MATH_OWN, C.TENSOR_OWN, C.NN_OWN,
                              C.OPT_CASES, C.SEQ_OWN, C.LOSS_OWN,
                              C.MISC_OWN, C.TAIL_OWN)
               for c in d.values()} | {"nce"}
    assert len(ops) >= 351
    assert not ops - covered - set(C.RANDOM) - EXEMPT

"""The port's tensor ops (paddle_tpu_torch/fluid/ops/tensor_ops.py)
against the JAX package's on the CPU: every op the module registers
runs the case of tests/test_op_sweep.py where that suite has one, or a
case of its own (both in tests/torch_op_cases.py), through both
registries; outputs and the static append_backward gradients are
compared (tolerances in tests/torch_op_parity.py)."""
import pytest

import torch_op_parity as P
from torch_op_cases import TENSOR_OWN as OWN
from torch_op_cases import SWEEP

OPS = P.module_ops("tensor_ops")
CASES = {**{k: c for k, c in SWEEP.items() if c.op in OPS}, **OWN}


def test_every_op_of_the_module_has_a_case():
    assert len(OPS) == 54
    assert set(OPS) <= {c.op for c in CASES.values()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_outputs_match_the_reference(name):
    P.check_outputs(CASES[name])


@pytest.mark.parametrize("name", sorted(
    k for k, c in CASES.items() if P.differentiable(c)))
def test_gradients_match_the_reference(name):
    P.check_grads(CASES[name])

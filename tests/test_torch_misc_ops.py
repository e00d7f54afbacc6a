"""The port's misc ops (paddle_tpu_torch/fluid/ops/misc_ops.py) against
the JAX package's on the CPU: every op the module registers runs its
cases of tests/torch_op_cases.py (MISC_OWN) through both registries;
outputs and the static append_backward gradients are compared
(tolerances in tests/torch_op_parity.py)."""
import pytest

import torch_op_parity as P
from torch_op_cases import MISC_OWN as CASES

OPS = P.module_ops("misc_ops")


def test_every_op_of_the_module_has_a_case():
    assert len(OPS) == 31
    assert set(OPS) <= {c.op for c in CASES.values()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_outputs_match_the_reference(name):
    P.check_outputs(CASES[name])


@pytest.mark.parametrize("name", sorted(
    k for k, c in CASES.items() if P.differentiable(c)))
def test_gradients_match_the_reference(name):
    P.check_grads(CASES[name])

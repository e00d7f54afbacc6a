"""The port's sequence ops (paddle_tpu_torch/fluid/ops/sequence_ops.py)
against the JAX package's on the CPU: every op the module registers runs
the case of tests/test_op_sweep.py where that suite has one and the
cases of its own (both in tests/torch_op_cases.py: SEQ_OWN, among them
the rnn op as LAC's two-layer bidirectional GRU with uneven lengths, a
bidirectional LSTM from given states and a tanh layer) through both
registries; outputs and the static append_backward gradients are
compared (tolerances in tests/torch_op_parity.py). The rnn op's dropout
between layers draws masks jax.random cannot replay: it is held to its
test mode and to one seed's reproducibility."""
import numpy as np
import pytest

import torch_op_parity as P
from torch_op_cases import SEQ_OWN as OWN
from torch_op_cases import SWEEP

OPS = P.module_ops("sequence_ops")
CASES = {**{k: c for k, c in SWEEP.items() if c.op in OPS}, **OWN}


def test_every_op_of_the_module_has_a_case():
    assert len(OPS) == 9
    assert set(OPS) <= {c.op for c in CASES.values()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_outputs_match_the_reference(name):
    P.check_outputs(CASES[name])


@pytest.mark.parametrize("name", sorted(
    k for k, c in CASES.items() if P.differentiable(c)))
def test_gradients_match_the_reference(name):
    P.check_grads(CASES[name])


def test_rnn_dropout_test_mode_and_one_seed():
    """Between layers at p > 0: the same seed gives the same output (the
    grad op's re-run relies on it), another seed another; in test mode
    the p = 0 output."""
    base = OWN["rnn_gru_bi2"]
    a = dict(base.attrs, dropout_prob=0.5)
    one = P.run_port("rnn", base.inputs, a, seed=3)["Out"][0]
    again = P.run_port("rnn", base.inputs, a, seed=3)["Out"][0]
    other = P.run_port("rnn", base.inputs, a, seed=4)["Out"][0]
    np.testing.assert_array_equal(one, again)
    assert not np.array_equal(one, other)
    p0 = P.run_port("rnn", base.inputs, base.attrs)["Out"][0]
    np.testing.assert_array_equal(
        P.run_port("rnn", base.inputs, a, is_test=True)["Out"][0], p0)
    assert not np.allclose(one, p0)

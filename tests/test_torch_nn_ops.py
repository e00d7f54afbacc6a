"""The port's nn ops (paddle_tpu_torch/fluid/ops/nn_ops.py, with the
fused_attention and paged_attention ops) against the JAX package's on
the CPU: every op the module registers runs the case of
tests/test_op_sweep.py where that suite has one, or a case of its own
(both in tests/torch_op_cases.py), through both registries; outputs
and the static append_backward gradients are compared (tolerances in
tests/torch_op_parity.py). The stochastic ops at p > 0 draw masks the
reference's jax.random cannot replay: they are held to their rate, to
test mode, and to the port's own reproducibility from one seed."""
import numpy as np
import pytest
import torch

import torch_op_parity as P
from torch_op_cases import NN_OWN as OWN
from torch_op_cases import SWEEP, OpCase


def _pos(shape, seed):
    return np.random.RandomState(seed).uniform(0.5, 1.5, shape) \
        .astype(np.float32)

OPS = P.module_ops("nn_ops")
CASES = {**{k: c for k, c in SWEEP.items() if c.op in OPS}, **OWN}
# dropout's sweep case is at p = 0 with its gradient skipped there (a
# stochastic op); at p > 0 the tests below hold the port's gradient
GRAD_SKIP = {"dropout"}


def test_every_op_of_the_module_has_a_case():
    # the module's 39 and the two attention ops
    assert len(OPS) == 41
    assert set(OPS) <= {c.op for c in CASES.values()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_outputs_match_the_reference(name):
    P.check_outputs(CASES[name])


@pytest.mark.parametrize("name", sorted(
    k for k, c in CASES.items() if P.differentiable(c)
    and k not in GRAD_SKIP))
def test_gradients_match_the_reference(name):
    P.check_grads(CASES[name])


@pytest.mark.parametrize("op,attrs,slot", [
    ("dropout", {"dropout_prob": 0.25,
                 "dropout_implementation": "upscale_in_train"}, "Out"),
    ("fused_dropout_add_ln", {"dropout_p": 0.25}, "Out"),
    ("fused_out_ln", {"dropout_p": 0.25}, "Out"),
    ("fused_ffn_block", {"dropout_p": 0.25}, "Out"),
    ("fused_attention", {"dropout_p": 0.25}, "Out")])
def test_dropout_rate_test_mode_and_one_seed(op, attrs, slot):
    """At p > 0 the port's masks: the same run seed and op id give the
    same output (which the grad op's re-run relies on); another seed
    another; test mode is the p = 0 output; dropout keeps about 1 - p
    of its entries, scaled by 1 / (1 - p)."""
    base = OWN.get(op) or OpCase(op, {"X": _pos((64, 64), 45)})
    ins = dict(base.inputs)
    if op == "dropout":
        ins = {"X": _pos((64, 64), 45)}
    a = dict(base.attrs, **attrs)
    one = P.run_port(op, ins, a, seed=3)[slot][0]
    again = P.run_port(op, ins, a, seed=3)[slot][0]
    other = P.run_port(op, ins, a, seed=4)[slot][0]
    np.testing.assert_array_equal(one, again)
    assert not np.array_equal(one, other)
    off = P.run_port(op, ins, dict(a, **{k: 0.0 for k in attrs
                                         if k.endswith("_p")}))[slot][0] \
        if op != "dropout" else ins["X"]
    np.testing.assert_allclose(P.run_port(op, ins, a, is_test=True)[slot][0],
                               off, rtol=1e-6, atol=1e-6)
    if op == "dropout":
        kept = one != 0
        assert abs(kept.mean() - 0.75) < 0.03
        np.testing.assert_allclose(one[kept], ins["X"][kept] / 0.75,
                                   rtol=1e-6)
        mask = P.run_port(op, ins, a, seed=3)["Mask"][0]
        np.testing.assert_array_equal(mask.astype(bool), kept)


def test_dropout_grad_replays_the_forward_mask():
    """The auto grad op re-runs dropout's forward with the same seed:
    the gradient is the mask scaled by 1 / (1 - p)."""
    from paddle_tpu_torch.fluid import registry
    from paddle_tpu_torch.fluid.executor import ExecContext
    x = torch.as_tensor(_pos((32, 32), 46))
    attrs = {"dropout_prob": 0.5, "_rng_id": 7,
             "dropout_implementation": "upscale_in_train"}
    registry.require("dropout").fill_default_attrs(attrs)
    ctx = ExecContext(11, device="cpu")
    out = registry.require("dropout").compute(ctx, {"X": [x]}, attrs)
    g = registry.require("dropout_grad").compute(
        ctx, {"X": [x], "Out@GRAD": [torch.ones_like(x)]}, attrs)
    np.testing.assert_array_equal(g["X@GRAD"][0].numpy(),
                                  out["Mask"][0].numpy() * 2.0)

"""The port's optimizer, random and metric ops
(paddle_tpu_torch/fluid/ops/{optimizer,random,metric}_ops.py) against
the JAX package's on the CPU.

Every update op and gradient utility runs one step on the same numpy
state in both registries, its outputs compared (f32 rtol 1e-5 / atol
1e-6); the differentiable utilities (clip_by_norm, lerp) also compare
their append_backward gradients. The random ops cannot be replayed
(jax.random): each is held to its shape, dtype, range and moments, and
to the port's reproducibility from one seed. The metric ops compare
outputs."""
import numpy as np
import pytest
import torch

import torch_op_parity as P
from torch_op_cases import OPT_CASES as CASES
from torch_op_cases import RANDOM

MODULES = ("optimizer_ops", "random_ops", "metric_ops")


def test_every_op_of_the_modules_has_a_case():
    ops = [o for m in MODULES for o in P.module_ops(m)]
    assert len(ops) == 21 + 10 + 2
    assert set(ops) <= {c.op for c in CASES.values()} | set(RANDOM)


@pytest.mark.parametrize("name", sorted(CASES))
def test_outputs_match_the_reference(name):
    P.check_outputs(CASES[name])


@pytest.mark.parametrize("name", ["clip_by_norm", "lerp"])
def test_gradients_match_the_reference(name):
    P.check_grads(CASES[name])


def _draw(op, seed):
    attrs, ins = RANDOM[op]
    return P.run_port(op, ins, attrs, seed=seed)["Out"][0], \
        P.run_ref(op, ins, attrs)["Out"][0]


@pytest.mark.parametrize("op", sorted(RANDOM))
def test_random_ops_agree_in_distribution(op):
    got, ref = _draw(op, 5)
    again, _ = _draw(op, 5)
    np.testing.assert_array_equal(got, again)         # one seed, one draw
    assert got.shape == ref.shape, op
    assert got.dtype.kind == np.asarray(ref).dtype.kind, op
    if op == "seed":
        np.testing.assert_array_equal(got, ref)
        return
    other, _ = _draw(op, 6)
    assert not np.array_equal(got, other), op
    if op == "randperm":
        np.testing.assert_array_equal(np.sort(got), np.arange(50))
        return
    if op in ("multinomial", "sampling_id"):
        probs = RANDOM[op][1]["X"][0]
        for v in (got, ref):
            if op == "multinomial":   # without replacement: distinct
                assert all(len(set(r)) == 3 for r in v)
            freq = np.bincount(v.reshape(-1)[::v.shape[-1]]
                               if op == "multinomial" else v.reshape(-1),
                               minlength=len(probs)) / (v.shape[0])
            np.testing.assert_allclose(freq, probs, atol=0.05)
        return
    lo, hi = {"uniform_random": (-2, 3), "randint": (3, 8),
              "uniform_random_batch_size_like": (0, 1),
              "truncated_gaussian_random": (-0.04, 0.04),
              "bernoulli": (0, 1)}.get(op, (-np.inf, np.inf))
    for v in (got, ref):
        assert v.min() >= lo and v.max() <= hi, op
    # moments within five standard errors of each other
    n = got.size
    se = np.sqrt(ref.var() / n + got.var() / n)
    assert abs(got.mean() - ref.mean()) < 5 * se + 1e-7, op
    assert abs(got.std() - ref.std()) < 0.05 * ref.std() + 1e-7, op


def test_dpsgd_noise_has_its_scale():
    attrs = {"clip": 1.0, "sigma": 2.0, "batch_size": 4.0}
    ins = {"Param": np.zeros((200, 50), np.float32),
           "Grad": np.zeros((200, 50), np.float32),
           "LearningRate": np.array([1.0], np.float32)}
    got = P.run_port("dpsgd", ins, attrs, seed=1)["ParamOut"][0]
    assert abs(got.std() - 0.5) < 0.02 and abs(got.mean()) < 0.02
    np.testing.assert_array_equal(
        got, P.run_port("dpsgd", ins, attrs, seed=1)["ParamOut"][0])


def test_update_ops_raise_on_a_sparse_gradient():
    from paddle_tpu_torch.fluid import registry
    for op in ("lamb", "adamax", "rmsprop"):
        with pytest.raises(NotImplementedError, match="dense gradient"):
            registry.require(op).compute(None, {
                "Param": [torch.zeros(2)], "Grad": [object()]}, {})

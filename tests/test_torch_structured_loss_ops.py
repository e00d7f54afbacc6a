"""The port's structured and sampled losses (paddle_tpu_torch/fluid/ops/
structured_loss_ops.py) against the JAX package's on the CPU: warpctc
(with norm_by_times and repeated labels), linear_chain_crf,
crf_decoding and hierarchical_sigmoid run their cases (tests/
torch_op_cases.py LOSS_OWN) through both registries, outputs and the
static append_backward gradients compared (tolerances in tests/
torch_op_parity.py). nce draws its negatives with jax.random in the
reference, which cannot be replayed: the port's cost as a function of
given samples (structured_loss_ops.nce_cost) is held to the reference
op's cost and sample logits on the samples the reference drew, for
both samplers, and the port's op to its own draw."""
import numpy as np
import pytest
import torch

import torch_op_parity as P
from torch_op_cases import LOSS_NCE
from torch_op_cases import LOSS_OWN as CASES
from paddle_tpu_torch.fluid.ops.structured_loss_ops import nce_cost

OPS = P.module_ops("structured_loss_ops")


def test_every_op_of_the_module_has_a_case():
    assert len(OPS) == 5
    assert set(OPS) - {"nce"} <= {c.op for c in CASES.values()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_outputs_match_the_reference(name):
    P.check_outputs(CASES[name])


@pytest.mark.parametrize("name", sorted(
    k for k, c in CASES.items() if P.differentiable(c)))
def test_gradients_match_the_reference(name):
    P.check_grads(CASES[name])


def _t(a):
    return torch.as_tensor(np.array(a, copy=True))


@pytest.mark.parametrize("sampler", [0, 1])
def test_nce_cost_on_the_reference_s_samples(sampler):
    attrs = {"num_total_classes": 9, "num_neg_samples": 5,
             "sampler": sampler}
    ref = P.run_ref("nce", LOSS_NCE, attrs)
    neg = ref["SampleLabels"][0]
    cost, logits = nce_cost(_t(LOSS_NCE["Input"]), _t(LOSS_NCE["Label"]),
                            _t(LOSS_NCE["Weight"]), _t(LOSS_NCE["Bias"]),
                            _t(neg), 9, sampler)
    np.testing.assert_allclose(cost[:, None].numpy(), ref["Cost"][0],
                               **P.OUT_TOL)
    np.testing.assert_allclose(logits.numpy(), ref["SampleLogits"][0],
                               **P.OUT_TOL)


def test_nce_cost_gradient_on_the_reference_s_samples():
    """d cost / d (input, weight, bias) on fixed samples: the reference's
    jax.vjp of its op's cost (its samples fixed by its key) against
    autograd through nce_cost on the same samples."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.fluid import registry as jreg
    from paddle_tpu.fluid.executor import ExecContext
    attrs = {"num_total_classes": 9, "num_neg_samples": 5, "sampler": 0,
             "seed": 0, "is_sparse": False, "_rng_id": 0}
    ctx = ExecContext(jax.random.PRNGKey(0))

    def cost(inp, w, b):
        outs = jreg.require("nce").compute(ctx, {
            "Input": [inp], "Label": [jnp.asarray(LOSS_NCE["Label"])],
            "Weight": [w], "Bias": [b]}, attrs)
        return jnp.sum(outs["Cost"][0]), outs["SampleLabels"][0]

    (_, neg), grads = jax.value_and_grad(cost, argnums=(0, 1, 2),
                                         has_aux=True)(
        *(jnp.asarray(LOSS_NCE[k]) for k in ("Input", "Weight", "Bias")))
    leaves = [_t(LOSS_NCE[k]).requires_grad_() for k in ("Input", "Weight",
                                                         "Bias")]
    c, _ = nce_cost(leaves[0], _t(LOSS_NCE["Label"]), leaves[1], leaves[2],
                    _t(np.asarray(neg)), 9)
    c.sum().backward()
    for leaf, g in zip(leaves, grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g),
                                   **P.GRAD_TOL)


@pytest.mark.parametrize("sampler", [0, 1])
def test_the_nce_op_costs_its_own_draw(sampler):
    """The port's op: samples in range, drawn the same from one seed
    (the grad op's re-run relies on it) and otherwise from another; its
    cost is nce_cost on them."""
    attrs = {"num_total_classes": 9, "num_neg_samples": 6,
             "sampler": sampler}
    a = P.run_port("nce", LOSS_NCE, attrs, seed=3)
    b = P.run_port("nce", LOSS_NCE, attrs, seed=3)
    c = P.run_port("nce", LOSS_NCE, attrs, seed=4)
    neg = a["SampleLabels"][0]
    assert neg.shape == (4, 6) and neg.min() >= 0 and neg.max() < 9
    np.testing.assert_array_equal(neg, b["SampleLabels"][0])
    assert not np.array_equal(neg, c["SampleLabels"][0])
    cost, _ = nce_cost(_t(LOSS_NCE["Input"]), _t(LOSS_NCE["Label"]),
                       _t(LOSS_NCE["Weight"]), _t(LOSS_NCE["Bias"]),
                       _t(neg), 9, sampler)
    np.testing.assert_array_equal(a["Cost"][0], cost[:, None].numpy())

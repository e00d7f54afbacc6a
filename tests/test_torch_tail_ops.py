"""The port's tail ops (paddle_tpu_torch/fluid/ops/tail_ops.py) against
the JAX package's on the CPU: every op the module registers runs its
cases of tests/torch_op_cases.py (TAIL_OWN) through both registries;
outputs and the static append_backward gradients are compared
(tolerances in tests/torch_op_parity.py). gaussian_random_batch_size_like
is held to the reference in distribution with the other random ops
(tests/test_torch_optimizer_ops.py, torch_op_cases.RANDOM).

Where the reference's output is not unique, what is unique is held:
QR's Q and R are unique up to the sign of each column of Q (and row of
R), so the product, |R| and Q's orthonormality are compared; an SVD's
singular values are unique and its vectors up to sign, so S, |U|, |VH|
and the reconstruction; eigh's eigenvalues and, up to sign, its
eigenvectors (|V| and V diag(w) V^T); LU with partial pivoting can pick
another of equal candidates, so P L U = A and |det| are compared. These
parts are torch_op_cases.UNIQUE_PARTS, which chip_smoke.py's card sweep
compares too. The complex ops' outputs are compared as complex
numbers."""
import numpy as np
import pytest

import torch_op_parity as P
from torch_op_cases import TAIL_OWN as CASES, UNIQUE_PARTS, lu_product

OPS = P.module_ops("tail_ops")
NOT_UNIQUE = {"qr", "svd", "eigh", "eigh_upper", "lu"}
COMPLEX = {"complex", "as_complex"}
TOL = P.OUT_TOL


def test_every_op_of_the_module_has_a_case():
    import torch_op_cases as C
    assert len(OPS) == 68
    assert set(OPS) <= {c.op for c in CASES.values()} | set(C.RANDOM)


@pytest.mark.parametrize("name", sorted(set(CASES) - NOT_UNIQUE - COMPLEX))
def test_outputs_match_the_reference(name):
    P.check_outputs(CASES[name])


@pytest.mark.parametrize("name", sorted(
    k for k, c in CASES.items() if P.differentiable(c)))
def test_gradients_match_the_reference(name):
    P.check_grads(CASES[name])


def _both(name):
    c = CASES[name]
    return P.run_ref(c.op, c.inputs, c.attrs), \
        P.run_port(c.op, c.inputs, c.attrs), c.inputs


@pytest.mark.parametrize("name", sorted(COMPLEX))
def test_complex_outputs_match_the_reference(name):
    ref, got, _ = _both(name)
    assert got["Out"][0].dtype == np.complex64
    np.testing.assert_allclose(got["Out"][0], ref["Out"][0], **TOL)


def _unique(op, ref, got):
    """UNIQUE_PARTS[op] of the reference's and of the port's outputs."""
    return UNIQUE_PARTS[op](ref), UNIQUE_PARTS[op](got)


def test_qr_is_the_reference_s_up_to_signs():
    ref, got, ins = _both("qr")
    want, have = _unique("qr", ref, got)
    q, r = got["Q"][0], got["R"][0]
    np.testing.assert_allclose(have["QR"], ins["X"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(have["QR"], want["QR"], **TOL)
    np.testing.assert_allclose(have["|R|"], want["|R|"], **TOL)
    np.testing.assert_allclose(np.triu(r), r)
    np.testing.assert_allclose(q.T @ q, np.eye(3), atol=1e-5)


def test_svd_is_the_reference_s_up_to_signs():
    ref, got, ins = _both("svd")
    want, have = _unique("svd", ref, got)
    for k in ("S", "|U|", "|VH|"):
        np.testing.assert_allclose(have[k], want[k], err_msg=k, **TOL)
    np.testing.assert_allclose(have["USVH"], ins["X"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["eigh", "eigh_upper"])
def test_eigh_is_the_reference_s_up_to_signs(name):
    ref, got, ins = _both(name)
    want, have = _unique("eigh", ref, got)
    np.testing.assert_allclose(have["Eigenvalues"], want["Eigenvalues"],
                               **TOL)
    np.testing.assert_allclose(have["|V|"], want["|V|"], rtol=1e-5,
                               atol=1e-5)
    tri = np.triu if CASES[name].attrs.get("UPLO") == "U" else np.tril
    sym = tri(ins["X"]) + tri(ins["X"]).T - np.diag(np.diag(ins["X"]))
    np.testing.assert_allclose(have["VWVT"], sym, rtol=1e-5, atol=1e-5)


def test_lu_reconstructs_the_matrix_as_the_reference():
    ref, got, ins = _both("lu")
    want, have = _unique("lu", ref, got)
    lu, piv = got["Out"][0], got["Pivots"][0]
    assert piv.dtype == np.int32
    np.testing.assert_allclose(have["PLU"], ins["X"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(want["PLU"], ins["X"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(have["|det|"], abs(np.linalg.det(ins["X"])),
                               rtol=1e-5)
    assert (np.abs(np.tril(lu, -1)) <= 1 + 1e-6).all()   # partial pivoting


def test_lu_product_undoes_the_row_swaps():
    """lu_product, the pivot rule both the tests and the card sweep use,
    rebuilds the matrix from LAPACK's own packed factor and 0-based
    swaps (scipy's lu_factor), on a matrix whose pivoting swaps rows."""
    from scipy.linalg import lu_factor
    a = np.random.RandomState(38).randn(5, 5)
    lu, piv = lu_factor(a)
    assert (piv != np.arange(5)).any()
    np.testing.assert_allclose(lu_product(lu, piv), a, atol=1e-12)

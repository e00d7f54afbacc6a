"""Fused layer norm in the port (paddle_tpu_torch/ops/layer_norm.py)
against the JAX package's Pallas kernels run in interpret mode (as its
own tests run them on the CPU) and against its composed _ln_xla_ref, on
the same numpy inputs: the output, the saved statistics and every
gradient. On the CPU the port's entry point runs the plain versions of
its two kernels; the CUDA kernels are held to those on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import pallas_layer_norm as jl
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import layer_norm as port

# float32: a row's sums (C terms) run in another order than XLA's, and
# dscale/dbias sum R rows; bf16: the same bf16 inputs, f32 arithmetic on
# both sides, one rounding of each output to bf16 (2**-8 relative)
TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
EPS = 1e-12   # BERT's


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")


def _inputs(r, c, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(r, c).astype(np.float32) * 2.0 + 0.5,
            (rng.rand(c) + 0.5).astype(np.float32),
            rng.randn(c).astype(np.float32),
            rng.randn(r, c).astype(np.float32))


def _port(x, s, b, dy, dtype, eps=EPS):
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    st, bt = (torch.from_numpy(a).requires_grad_() for a in (s, b))
    y, mean, rstd = port.fused_layer_norm(xt, st, bt, eps)
    assert not mean.requires_grad and not rstd.requires_grad
    assert mean.dtype == rstd.dtype == torch.float32
    grads = torch.autograd.grad(y, (xt, st, bt),
                                torch.from_numpy(dy).to(dtype))
    assert [g.dtype for g in grads] == [dtype, torch.float32, torch.float32]
    return [t.detach().float().numpy() for t in (y, mean, rstd, *grads)]


def _jax(x, s, b, dy, dtype, eps=EPS):
    jd = _JDT[dtype]
    args = (jnp.asarray(x, jd), jnp.asarray(s), jnp.asarray(b))
    (y, mean, rstd), vjp = jax.vjp(
        lambda *a: jl.fused_layer_norm(*a, eps), *args)
    r = x.shape[0]
    grads = vjp((jnp.asarray(dy, jd), jnp.zeros(r), jnp.zeros(r)))
    return [np.asarray(t, np.float32) for t in (y, mean, rstd, *grads)]


NAMES = ("y", "mean", "rstd", "dx", "dscale", "dbias")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,c", [(16, 128), (304, 256), (8, 768)])
def test_layer_norm_matches_jax_pallas_interpret(r, c, dtype, interpret):
    assert jl.can_use_fused_ln(r, c, True, True)
    a = _inputs(r, c)
    for name, g, w in zip(NAMES, _port(*a, dtype), _jax(*a, dtype)):
        tol = TOL[torch.float32] if name in ("mean", "rstd") else TOL[dtype]
        if name in ("dscale", "dbias"):       # sums over R rows
            tol = dict(atol=tol["atol"] * r ** 0.5, rtol=tol["rtol"])
        np.testing.assert_allclose(g, w, err_msg=name, **tol)


@pytest.mark.parametrize("r,c", [(16, 128), (5, 100), (1, 1), (3, 16384)])
def test_layer_norm_matches_composed_reference(r, c):
    """Any R and C (the TPU kernel wants R % 8 == 0 and C % 128 == 0):
    against the reference's composed chain and autograd through it."""
    x, s, b, dy = _inputs(r, c, seed=1)
    got = _port(x, s, b, dy, torch.float32, 1e-5)
    f = lambda *a: jl._ln_xla_ref(*a, 1e-5)
    y, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    want = [np.asarray(t) for t in (y, *vjp(jnp.asarray(dy)))]
    for name, g, w in zip(("y", "dx", "dscale", "dbias"),
                          [got[0], *got[3:]], want):
        np.testing.assert_allclose(g, w, err_msg=name, atol=1e-4, rtol=1e-4)


def test_zero_variance_row_gives_rsqrt_eps():
    """eps = 1e-12 is below f32 resolution next to any real variance; a
    row of equal values has variance exactly 0 (two-pass statistics), so
    rstd = 1e6 and y = bias, with a finite dx."""
    x = np.full((4, 128), 3.25, np.float32)
    x[1] = np.random.RandomState(2).randn(128)
    s = np.ones(128, np.float32)
    b = np.linspace(-1, 1, 128).astype(np.float32)
    dy = np.random.RandomState(3).randn(4, 128).astype(np.float32)
    y, mean, rstd, dx, _, _ = _port(x, s, b, dy, torch.float32)
    np.testing.assert_allclose(rstd[[0, 2, 3]], 1e6, rtol=1e-6)
    np.testing.assert_allclose(mean[0], 3.25)
    np.testing.assert_array_equal(y[0], b)
    assert np.isfinite(dx).all()


def test_functional_layer_norm_routes_as_the_op():
    """F.layer_norm: the kernel pair when scale and bias are present, the
    composed chain otherwise; the op returns (Y, Mean, Variance)."""
    x, s, b, _ = _inputs(6, 64, seed=4)
    xt = torch.from_numpy(x).reshape(2, 3, 64)
    y, mean, var = F.layer_norm_op(xt, torch.from_numpy(s),
                                   torch.from_numpy(b), 1e-5, 2)
    assert y.shape == (2, 3, 64) and mean.shape == var.shape == (6,)
    np.testing.assert_allclose(var.numpy(), x.var(-1), rtol=1e-4)
    np.testing.assert_allclose(mean.numpy(), x.mean(-1), atol=1e-6)
    want = torch.nn.functional.layer_norm(
        xt, (64,), torch.from_numpy(s), torch.from_numpy(b), 1e-5)
    torch.testing.assert_close(y, want, atol=1e-5, rtol=1e-5)
    no_affine = F.layer_norm(xt, 64, None, None, 1e-5)
    torch.testing.assert_close(
        no_affine, torch.nn.functional.layer_norm(xt, (64,), eps=1e-5),
        atol=1e-5, rtol=1e-5)
    only_scale = F.layer_norm(xt, [64], torch.from_numpy(s), None, 1e-5)
    torch.testing.assert_close(only_scale, no_affine * torch.from_numpy(s),
                               atol=1e-5, rtol=1e-5)


def test_bad_shapes_and_devices_raise():
    s = torch.ones(4)
    with pytest.raises(ValueError, match="2-d"):
        port.fused_layer_norm(torch.zeros(2, 2, 4), s, s)
    with pytest.raises(ValueError, match="16384"):
        port.fused_layer_norm(torch.zeros(2, 16385), torch.ones(16385),
                              torch.ones(16385))
    with pytest.raises(ValueError, match="no kernel"):
        port.fused_layer_norm(torch.empty(2, 4, device="meta"), s, s)


# -- the two routes of the CUDA kernels (picked on the host, before launch) --

def _buf(n, dtype, offset=0):
    """n elements of dtype viewed `offset` elements into their storage."""
    return torch.zeros(n + offset, dtype=dtype)[offset:]


# (C, dtype, element offset of x, want)
ROUTE_CASES = {
    "bert_f32": (768, torch.float32, 0, "warp"),
    "bert_bf16": (768, torch.bfloat16, 0, "warp"),
    "one_vector_f32": (4, torch.float32, 0, "warp"),
    "one_vector_bf16": (8, torch.bfloat16, 0, "warp"),
    "cap_f32": (1024, torch.float32, 0, "warp"),
    "cap_bf16": (1024, torch.bfloat16, 0, "warp"),
    "cap_plus_a_vector_f32": (1028, torch.float32, 0, "row"),
    "cap_plus_a_vector_bf16": (1032, torch.bfloat16, 0, "row"),
    "c7": (7, torch.float32, 0, "row"),
    "c12_bf16": (12, torch.bfloat16, 0, "row"),
    "c16384": (16384, torch.float32, 0, "row"),
    "misaligned_f32": (768, torch.float32, 1, "row"),
    "misaligned_bf16": (768, torch.bfloat16, 4, "row"),
    "float16": (768, torch.float16, 0, "row"),
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_ln_route(case):
    c, dtype, offset, want = ROUTE_CASES[case]
    x = _buf(4 * c, dtype, offset)
    s = _buf(c, torch.float32)
    assert port.ln_route(c, dtype, [x.data_ptr(), s.data_ptr()]) == want


@pytest.mark.parametrize("r,sms,want", [
    (304, 132, (2, 152)),    # BERT's MLM head: every SM takes a block
    (2048, 132, (8, 256)),   # BERT's tokens: one wave of 2 blocks an SM
    (1, 132, (1, 1)),
    (131, 132, (1, 131)),
    (8192, 132, (8, 264)),   # past a wave: each warp walks 4 rows
    (304, 114, (2, 152))])
def test_ln_grid(r, sms, want):
    rows, blocks = port.ln_grid(r, sms)
    assert (rows, blocks) == want
    assert 1 <= rows <= 8 and blocks <= 2 * sms
    assert rows * blocks >= min(r, rows * 2 * sms)

"""Fused dropout + residual add + layer norm in the port
(paddle_tpu_torch/ops/fused_residual.py) against the JAX package's
Pallas kernels run in interpret mode and its composed _composed_ref, on
the same numpy inputs and the same int32 seed: the output and every
gradient, the dropout masks bit for bit. On the CPU the port's entry
point runs the plain versions of its two kernels; the CUDA kernels are
held to those on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import pallas_fused_residual as jr
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import fused_residual as port

# float32: a row's sums run in another order than XLA's, and a kept
# element is divided by 1 - p on both sides; bf16: same bf16 inputs, f32
# arithmetic, one rounding of each output (2**-8 relative)
TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=3e-2, rtol=3e-2)}
_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
EPS = 1e-12


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")


def _inputs(r, c, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(r, c).astype(np.float32),
            rng.randn(r, c).astype(np.float32),
            (rng.rand(c) + 0.5).astype(np.float32),
            rng.randn(c).astype(np.float32),
            rng.randn(r, c).astype(np.float32))


def _jax_keep(seed, r, c, p, row0=0):
    rows = jnp.broadcast_to(
        (jnp.arange(r, dtype=jnp.int32) + jnp.int32(row0))[:, None], (r, c))
    cols = jnp.broadcast_to(jnp.arange(c, dtype=jnp.int32)[None, :], (r, c))
    return np.asarray(jr._keep(jnp.asarray([seed], jnp.int32), rows, cols,
                               c, p))


@pytest.mark.parametrize("seed,p", [(0, 0.1), (7, 0.5), (-123456789, 0.1),
                                    (2 ** 31 - 1, 0.9), (5, 1e-12)])
def test_keep_mask_is_bit_equal_to_the_jax_hash(seed, p):
    r, c = 64, 384
    got = port.keep_mask(seed, r, c, p).numpy()
    np.testing.assert_array_equal(got, _jax_keep(seed, r, c, p))
    if 0.05 < p < 0.95:
        assert abs(got.mean() - (1 - p)) < 0.02


@pytest.mark.parametrize("row0", [65530, 131070, 262140])
def test_keep_mask_counter_wraps_like_int32(row0):
    """row * C + col passes 2**31 (int32 goes negative in jnp) and 2**32
    (uint32 wraps) at C = 32768: the last rows of such a grid hash the
    same way in both packages."""
    c, p, seed = 32768, 0.1, 11
    rows = torch.arange(row0, row0 + 8, dtype=torch.int64)[:, None]
    cols = torch.arange(c, dtype=torch.int64)[None, :]
    from paddle_tpu_torch.ops._launch import keep_threshold
    got = port.hash_u32(seed, rows * c + cols) >= keep_threshold(p)
    assert (row0 + 8) * c > 2 ** 31
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_keep(seed, 8, c, p, row0))


def _port_fwd_bwd(x, res, s, b, dy, seed, p, dtype):
    xt, rt = (torch.from_numpy(a).to(dtype).requires_grad_()
              for a in (x, res))
    st, bt = (torch.from_numpy(a).requires_grad_() for a in (s, b))
    y = port.fused_dropout_add_ln(xt, rt, st, bt, seed, p, EPS)
    grads = torch.autograd.grad(y, (xt, rt, st, bt),
                                torch.from_numpy(dy).to(dtype))
    assert [g.dtype for g in grads] == [dtype, dtype, torch.float32,
                                        torch.float32]
    return [t.detach().float().numpy() for t in (y, *grads)]


def _jax_fwd_bwd(fn, x, res, s, b, dy, seed, p, dtype):
    jd = _JDT[dtype]
    args = (jnp.asarray(x, jd), jnp.asarray(res, jd), jnp.asarray(s),
            jnp.asarray(b))
    y, vjp = jax.vjp(lambda *a: fn(*a, jnp.asarray([seed], jnp.int32), p,
                                   EPS), *args)
    return [np.asarray(t, np.float32) for t in (y, *vjp(jnp.asarray(dy, jd)))]


NAMES = ("y", "dx", "dres", "dscale", "dbias")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("r,c", [(16, 128), (304, 256), (64, 1024)])
def test_dropout_add_ln_matches_jax_pallas_interpret(r, c, p, dtype,
                                                     interpret):
    assert jr.can_use_fused_dropout_add_ln(r, c)
    a = _inputs(r, c)
    got = _port_fwd_bwd(*a, 1234, p, dtype)
    want = _jax_fwd_bwd(jr.fused_dropout_add_ln, *a, 1234, p, dtype)
    for name, g, w in zip(NAMES, got, want):
        tol = TOL[dtype]
        if name in ("dscale", "dbias"):       # sums over R rows
            tol = dict(atol=tol["atol"] * r ** 0.5, rtol=tol["rtol"])
        np.testing.assert_allclose(g, w, err_msg=name, **tol)
    if p > 0:
        # dx is zero exactly where the mask dropped: bit-equal masks
        np.testing.assert_array_equal(got[1] != 0, want[1] != 0)
        np.testing.assert_array_equal(got[1] != 0,
                                      port.keep_mask(1234, r, c, p).numpy())


@pytest.mark.parametrize("p", [0.0, 0.3])
@pytest.mark.parametrize("r,c", [(5, 100), (1, 8), (33, 768)])
def test_dropout_add_ln_matches_composed_reference(r, c, p):
    """Ragged R and C outside the TPU kernel's tiling, against autograd
    through the reference's composed chain."""
    a = _inputs(r, c, seed=1)
    got = _port_fwd_bwd(*a, -77, p, torch.float32)
    want = _jax_fwd_bwd(jr._composed_ref, *a, -77, p, torch.float32)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g, w, err_msg=name, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_p0_gradients_are_one_tensor_but_independent_leaves(dtype,
                                                            interpret):
    """At p = 0 the backward returns one tensor, dres, as the gradient
    of x and of res (dx = dz / 1 is dres bit for bit): both equal the
    JAX package's vjp, and autograd still gives each leaf its own
    storage, so changing x.grad leaves res.grad alone."""
    r, c = 16, 128
    x, res, s, b, dy = _inputs(r, c, seed=3)
    xt, rt = (torch.from_numpy(a).to(dtype).requires_grad_()
              for a in (x, res))
    st, bt = (torch.from_numpy(a).requires_grad_() for a in (s, b))
    port.fused_dropout_add_ln(xt, rt, st, bt, 5, 0.0, EPS).backward(
        torch.from_numpy(dy).to(dtype))
    want = _jax_fwd_bwd(jr.fused_dropout_add_ln, x, res, s, b, dy, 5, 0.0,
                        dtype)
    for name, g, w in (("dx", xt.grad, want[1]), ("dres", rt.grad, want[2])):
        np.testing.assert_allclose(g.float().numpy(), w, err_msg=name,
                                   **TOL[dtype])
    assert torch.equal(xt.grad, rt.grad)
    assert xt.grad.data_ptr() != rt.grad.data_ptr()
    kept = rt.grad.clone()
    xt.grad.add_(1)
    assert torch.equal(rt.grad, kept)
    # the plain version of the kernel returns the one tensor itself
    _, z, mean, rstd = port.dropout_add_ln_reference(
        xt.detach(), rt.detach(), st.detach(), bt.detach(), 5, 0.0, EPS)
    dx, dres = port.dropout_add_ln_bwd_reference(
        z, st.detach(), mean, rstd, torch.from_numpy(dy).to(dtype), 5, 0.0)
    assert dx is dres


def _misaligned(t):
    """A copy of `t` one element past its allocation's start (16-byte
    aligned on the CPU as on the card): not 16-byte aligned."""
    return torch.empty(t.numel() + 1, dtype=t.dtype)[1:].view(t.shape)


def _call_tensors(kernel, r, c, dtype, p=0.1):
    """The tensors one call of `kernel` reads and writes, in the order
    its wrapper hands them to ln_route through _ptrs: x, res, scale,
    bias, y, z (forward); z, scale, dy, dres, dx (backward; no dx at
    p = 0)."""
    row = [torch.empty(r, c, dtype=dtype) for _ in range(4)]
    vec = [torch.empty(c) for _ in range(2)]
    if kernel == "fwd":
        return [row[0], row[1], vec[0], vec[1], row[2], row[3]]
    return [row[0], vec[0], row[1], row[2], row[3] if p > 0 else None]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
def test_dal_route(kernel, dtype):
    """Rows 6-7 route by the layer norm's ln_route over the pointers of
    their calls: C = 768 and the cap 1024 on "warp"; one vector past the
    cap, C = 7, or any one misaligned tensor on "row"; at p = 0 the
    backward has no dx, which then decides nothing."""
    from paddle_tpu_torch.ops.layer_norm import WARP_MAX_COLS, ln_route
    past = WARP_MAX_COLS + (4 if dtype == torch.float32 else 8)

    def route(c, tensors):
        return ln_route(c, dtype, port._ptrs(*tensors))

    for c, want in ((768, "warp"), (WARP_MAX_COLS, "warp"), (past, "row"),
                    (7, "row")):
        assert route(c, _call_tensors(kernel, 8, c, dtype)) == want, c
    ts = _call_tensors(kernel, 8, 768, dtype)
    for i, t in enumerate(ts):
        off = ts[:i] + [_misaligned(t)] + ts[i + 1:]
        assert route(768, off) == "row", i
    if kernel == "bwd":
        p0 = _call_tensors(kernel, 8, 768, dtype, p=0.0)
        assert p0[-1] is None and len(port._ptrs(*p0)) == 4
        assert route(768, p0) == "warp"
        p0[0] = _misaligned(p0[0])
        assert route(768, p0) == "row"


def test_zero_variance_row():
    """x = 0 and an all-equal residual row: z has variance exactly 0,
    rstd = 1e6 at eps 1e-12, y = bias; gradients stay finite."""
    r, c = 4, 128
    x = np.zeros((r, c), np.float32)
    res = np.full((r, c), -1.5, np.float32)
    s = np.ones(c, np.float32)
    b = np.linspace(0, 1, c).astype(np.float32)
    dy = np.random.RandomState(0).randn(r, c).astype(np.float32)
    y, dx, dres, _, _ = _port_fwd_bwd(x, res, s, b, dy, 3, 0.1,
                                      torch.float32)
    np.testing.assert_array_equal(y, np.broadcast_to(b, (r, c)))
    assert np.isfinite(dx).all() and np.isfinite(dres).all()
    _, _, mean, rstd = port.dropout_add_ln_reference(
        *(torch.from_numpy(t) for t in (x, res, s, b)), 3, 0.1, EPS)
    np.testing.assert_allclose(rstd.numpy(), 1e6, rtol=1e-6)
    np.testing.assert_allclose(mean.numpy(), -1.5)


def test_functional_op_argument_handling():
    """F.fused_dropout_add_ln: p = 0 outside training, any leading
    shape, a seed from the stream when none is given."""
    x, res, s, b, _ = _inputs(6, 64, seed=2)
    xt, rt = (torch.from_numpy(a).reshape(2, 3, 64) for a in (x, res))
    st, bt = torch.from_numpy(s), torch.from_numpy(b)
    ev = F.fused_dropout_add_ln(xt, rt, st, bt, 0.5, 1e-5, training=False)
    want = torch.nn.functional.layer_norm(xt + rt, (64,), st, bt, 1e-5)
    torch.testing.assert_close(ev, want, atol=1e-5, rtol=1e-5)
    with F.seed_scope(9):
        a1 = F.fused_dropout_add_ln(xt, rt, st, bt, 0.5, 1e-5)
        a2 = F.fused_dropout_add_ln(xt, rt, st, bt, 0.5, 1e-5)
    with F.seed_scope(9):
        b1 = F.fused_dropout_add_ln(xt, rt, st, bt, 0.5, 1e-5)
    assert torch.equal(a1, b1) and not torch.equal(a1, a2)
    fixed = F.fused_dropout_add_ln(xt, rt, st, bt, 0.5, 1e-5, seed=4)
    torch.testing.assert_close(
        fixed.reshape(6, 64),
        port.dropout_add_ln_reference(xt.reshape(6, 64), rt.reshape(6, 64),
                                      st, bt, 4, 0.5, 1e-5)[0])


def test_bad_inputs_raise():
    x = torch.zeros(2, 4)
    s = torch.ones(4)
    with pytest.raises(TypeError, match="one type"):
        port.fused_dropout_add_ln(x, x.bfloat16(), s, s)
    with pytest.raises(ValueError, match="2-d"):
        port.fused_dropout_add_ln(x[None], x[None], s, s)
    with pytest.raises(ValueError, match="no kernel"):
        m = torch.empty(2, 4, device="meta")
        port.fused_dropout_add_ln(m, m, s, s)

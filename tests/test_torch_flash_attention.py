"""Flash attention in the port (paddle_tpu_torch/ops/flash_attention.py)
against the JAX package's Pallas flash kernels run in interpret mode (as
its own tests run them on the CPU) and against its sdpa_reference, on
the same numpy inputs: the output and the gradients of q, k and v. On
the CPU the port's entry point runs the plain versions of its three
kernels; the CUDA kernels are held to those on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py)."""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.flash_attention import sdpa_reference as j_sdpa
from paddle_tpu.ops.pallas_attention import flash_attention as j_flash
from paddle_tpu_torch.models import gpt as pgpt
from paddle_tpu_torch.ops import flash_attention as port

# float32: the sums run in another order than XLA's
TOL = dict(atol=1e-5, rtol=1e-5)
# bfloat16 in, f32 sums in both, P, the dropped P and dS rounded to
# bf16 before their products at the reference's points (P against the
# running max at the reference's key blocks), and each output rounded
# once to bf16 (8 bits of mantissa, 2**-8 ~ 4e-3 relative); the sums
# run in another order, so a rounding can land one bf16 step apart
# (test_flash_bf16_rounds_like_pallas_interpret holds how few do)
BF16_TOL = dict(atol=3e-2, rtol=3e-2)
B, H, D = 2, 2, 64


@pytest.fixture(scope="module", autouse=True)
def _fresh_jax_executables():
    """Drop executables another test file of this worker compiled (under
    its own env and config) before this file's first Pallas call."""
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _pinned_numerics(monkeypatch):
    """Each case runs on the state the tolerances assume, whatever an
    earlier file of the same worker left behind: f32 default dtype, no
    autocast, f32 matmuls at full precision on both sides, x64 off, the
    reference's default flash blocks (the port's ref_block is that
    default), and the port's kernel wrappers (not composed_ops)."""
    from paddle_tpu_torch.nn import functional as F
    for var in ("PADDLE_TPU_FLASH_BLOCK_Q", "PADDLE_TPU_FLASH_BLOCK_K",
                "PADDLE_TPU_DISABLE_PALLAS"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(F, "_composed", False)
    dtype = torch.get_default_dtype()
    prec = torch.get_float32_matmul_precision()
    x64 = jax.config.jax_enable_x64
    torch.set_default_dtype(torch.float32)
    torch.set_float32_matmul_precision("highest")
    jax.config.update("jax_enable_x64", False)
    try:
        with torch.autocast("cpu", enabled=False), \
                torch.enable_grad(), \
                jax.default_matmul_precision("highest"):
            yield
    finally:
        torch.set_default_dtype(dtype)
        torch.set_float32_matmul_precision(prec)
        jax.config.update("jax_enable_x64", x64)


def _inputs(t, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, t, D).astype(np.float32) for _ in range(4)]


def _port_fwd_bwd(q, k, v, do, causal, dtype=torch.float32):
    qt, kt, vt = (torch.from_numpy(a).to(dtype).requires_grad_()
                  for a in (q, k, v))
    o = port.flash_attention(qt, kt, vt, causal=causal)
    grads = torch.autograd.grad(o, (qt, kt, vt),
                                torch.from_numpy(do).to(dtype))
    return [o.detach().float().numpy()] + [g.float().numpy() for g in grads]


def _jax_fwd_bwd(fn, q, k, v, do, causal, dtype=jnp.float32):
    args = [jnp.asarray(a, dtype) for a in (q, k, v)]
    o, vjp = jax.vjp(lambda a, b, c: fn(a, b, c, causal=causal), *args)
    grads = vjp(jnp.asarray(do, dtype))
    return [np.asarray(o, np.float32)] + [np.asarray(g, np.float32)
                                          for g in grads]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [64, 128])
def test_flash_matches_jax_pallas_interpret(t, causal):
    q, k, v, do = _inputs(t)
    got = _port_fwd_bwd(q, k, v, do, causal)
    want = _jax_fwd_bwd(j_flash, q, k, v, do, causal)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [64, 128])
def test_flash_matches_jax_sdpa_reference(t, causal):
    q, k, v, do = _inputs(t, seed=1)
    got = _port_fwd_bwd(q, k, v, do, causal)
    want = _jax_fwd_bwd(j_sdpa, q, k, v, do, causal)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_matches_jax_pallas_interpret(causal):
    q, k, v, do = _inputs(128, seed=2)
    got = _port_fwd_bwd(q, k, v, do, causal, torch.bfloat16)
    want = _jax_fwd_bwd(j_flash, q, k, v, do, causal, jnp.bfloat16)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **BF16_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_kernels_match_autograd_of_the_oracle(causal):
    """flash_fwd_reference's lse is the row logsumexp, and
    flash_bwd_reference (P recomputed from lse) equals autograd through
    the composed sdpa_reference."""
    q, k, v, do = (torch.from_numpy(a).reshape(B * H, 128, D)
                   for a in _inputs(128, seed=3))
    scale = 1.0 / math.sqrt(D)
    o, lse = port.flash_fwd_reference(q, k, v, scale, causal)
    s = q @ k.transpose(1, 2) * scale
    if causal:
        s = s.masked_fill(~torch.ones(128, 128, dtype=torch.bool).tril(),
                          float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), **TOL)
    dq, dk, dv = port.flash_bwd_reference(q, k, v, o, lse, do, scale, causal)
    qr, kr, vr = (a.clone().requires_grad_() for a in (q, k, v))
    ref = port.sdpa_reference(qr[None], kr[None], vr[None], causal=causal)
    want = torch.autograd.grad(ref, (qr, kr, vr), do[None])
    for g, w in zip((dq, dk, dv), want):
        torch.testing.assert_close(g, w, **TOL)


def test_causal_attention_flash_matches_xla_impl():
    rng = np.random.RandomState(4)
    q, k, v = (torch.from_numpy(rng.randn(2, 64, 128).astype(np.float32))
               for _ in range(3))
    got = pgpt._causal_attention(q, k, v, 2, impl="flash")
    want = pgpt._causal_attention(q, k, v, 2, impl="xla")
    torch.testing.assert_close(got, want, **TOL)
    # the ring needs its axis (the reference raises the same)
    with pytest.raises(RuntimeError, match="ring_context"):
        pgpt._causal_attention(q, k, v, 2, impl="ring")


@pytest.mark.parametrize("shape", [(1, 2, 100, 64), (1, 2, 64, 12),
                                   (1, 2, 64, 264)])
def test_outside_the_domain_raises(shape):
    q = torch.zeros(shape)
    assert not port.can_use_flash(q, q, q)
    with pytest.raises(ValueError, match="multiples of 64"):
        port.flash_attention(q, q, q)


def test_mask_and_dropout_raise():
    """A padding mask and dropout raised NotImplementedError until the
    BERT slice; now both run. What still raises is a mask of another
    shape than (B, 1, 1, T), which the composed path takes instead."""
    q = torch.randn(1, 2, 64, 64, generator=torch.Generator().manual_seed(0))
    pad = torch.zeros(1, 1, 1, 64)
    pad[..., 48:] = -1e9
    assert port.can_use_flash(q, q, q, mask=pad)
    assert port.can_use_flash(q, q, q, dropout_p=0.1)
    o = port.flash_attention(q, q, q, mask=pad)
    torch.testing.assert_close(o, port.sdpa_reference(q, q, q, mask=pad),
                               **TOL)
    od = port.flash_attention(q, q, q, dropout_p=0.1, dropout_seed=5)
    torch.testing.assert_close(
        od, port.sdpa_reference(q, q, q, dropout_p=0.1, seed=5), **TOL)
    assert not torch.equal(od, port.flash_attention(q, q, q))
    full = torch.zeros(1, 1, 64, 64)
    assert not port.can_use_flash(q, q, q, mask=full)
    with pytest.raises(ValueError, match="mask"):
        port.flash_attention(q, q, q, mask=full)
    # the layers' entry takes the composed path for such a mask
    torch.testing.assert_close(
        port.scaled_dot_product_attention(q, q, q, attn_mask=full),
        port.sdpa_reference(q, q, q), **TOL)


def test_other_devices_raise():
    q = torch.empty(1, 2, 64, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        port.flash_attention(q, q, q)


# -- the BERT variants: an additive padding mask (B, 1, 1, T) and dropout
# on the probabilities by the salted counter hash, both replayed in the
# gradients. Same numpy inputs and the same int32 seed through both
# packages; the JAX side is the Pallas kernels in interpret mode.
def _pad_mask(t, seed=0):
    """(B, 1, 1, T) additive mask: each batch row pads its own tail."""
    m = np.zeros((B, 1, 1, t), np.float32)
    lens = np.random.RandomState(seed).randint(t // 2, t, (B,))
    for b, n in enumerate(lens):
        m[b, ..., n:] = -1e9
    return m


def _port_variant(q, k, v, do, causal, mask, p, seed, dtype=torch.float32):
    qt, kt, vt = (torch.from_numpy(a).to(dtype).requires_grad_()
                  for a in (q, k, v))
    mt = None if mask is None else torch.from_numpy(mask)
    o = port.flash_attention(qt, kt, vt, mt, None, causal, p, seed)
    grads = torch.autograd.grad(o, (qt, kt, vt),
                                torch.from_numpy(do).to(dtype))
    return [o.detach().float().numpy()] + [g.float().numpy() for g in grads]


def _jax_variant(q, k, v, do, causal, mask, p, seed, dtype=jnp.float32):
    args = [jnp.asarray(a, dtype) for a in (q, k, v)]
    mj = None if mask is None else jnp.asarray(mask)
    o, vjp = jax.vjp(lambda a, b, c: j_flash(a, b, c, mj, None, causal, p,
                                             seed), *args)
    grads = vjp(jnp.asarray(do, dtype))
    return [np.asarray(o, np.float32)] + [np.asarray(g, np.float32)
                                          for g in grads]


@pytest.mark.parametrize("seed,p", [(0, 0.1), (-99, 0.5), (2 ** 31 - 1, 0.1)])
def test_salted_keep_mask_is_bit_equal_to_the_jax_hash(seed, p):
    from paddle_tpu.ops.pallas_attention import _keep_mask
    bh, s, t = 5, 64, 128
    got = port.keep_mask_salted(seed, bh, s, t, p).numpy()
    rows = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[:, None], (s, t))
    cols = jnp.broadcast_to(jnp.arange(t, dtype=jnp.int32)[None, :], (s, t))
    sd = jnp.asarray([seed], jnp.int32)
    for i in range(bh):
        np.testing.assert_array_equal(
            got[i], np.asarray(_keep_mask(sd, i, rows, cols, t, p)))
    assert abs(got.mean() - (1 - p)) < 0.02
    assert not np.array_equal(got[0], got[1])      # salted by (b, h)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("with_mask,p", [(True, 0.0), (False, 0.1),
                                         (True, 0.1)])
def test_flash_mask_dropout_matches_jax_pallas_interpret(with_mask, p,
                                                         causal):
    t = 128
    q, k, v, do = _inputs(t, seed=5)
    mask = _pad_mask(t) if with_mask else None
    got = _port_variant(q, k, v, do, causal, mask, p, 4242)
    want = _jax_variant(q, k, v, do, causal, mask, p, 4242)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, atol=2e-5, rtol=2e-5)
    if with_mask:    # padded keys get no gradient
        for b in range(B):
            pad = mask[b, 0, 0] < 0
            assert np.all(got[2][b][:, pad] == 0)
            assert np.all(got[3][b][:, pad] == 0)


def test_flash_mask_dropout_bf16_matches_jax_pallas_interpret():
    q, k, v, do = _inputs(128, seed=6)
    mask = _pad_mask(128, seed=1)
    got = _port_variant(q, k, v, do, False, mask, 0.1, 7, torch.bfloat16)
    want = _jax_variant(q, k, v, do, False, mask, 0.1, 7, jnp.bfloat16)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **BF16_TOL)


def test_dropout_leaves_the_logsumexp_dropout_free():
    """The row sum is taken before the mask: lse is the same with and
    without dropout, and the dropped output is the kept probabilities
    over 1 - p times V (two identity-block V's expose the mask bit for
    bit)."""
    t, p, seed = 128, 0.25, 31
    q, k, _, _ = (torch.from_numpy(a).reshape(B * H, t, D)
                  for a in _inputs(t, seed=7))
    scale = 1.0 / math.sqrt(D)
    keep = port.keep_mask_salted(seed, B * H, t, t, p)
    _, lse0 = port.flash_fwd_reference(q, k, q, scale, False)
    for half in (0, 1):
        v = torch.zeros(B * H, t, D)
        v[:, half * D:(half + 1) * D] = torch.eye(D)
        o, lse = port.flash_fwd_reference(q, k, v, scale, False, None, seed,
                                          p)
        torch.testing.assert_close(lse, lse0, atol=0, rtol=0)
        assert torch.equal(o != 0, keep[:, :, half * D:(half + 1) * D])


@pytest.mark.parametrize("p", [0.0, 0.2])
def test_plain_backward_with_mask_and_dropout_matches_autograd(p):
    """flash_bwd_reference (P recomputed from the dropout-free lse, the
    mask replayed) equals autograd through the composed sdpa_reference
    under the same seed."""
    t = 128
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(t, seed=8))
    mask = torch.from_numpy(_pad_mask(t, seed=2))
    qr, kr, vr = (a.clone().requires_grad_() for a in (q, k, v))
    ref = port.sdpa_reference(qr, kr, vr, mask, None, False, p, 77)
    want = torch.autograd.grad(ref, (qr, kr, vr), do)
    q3, k3, v3, do3 = (a.reshape(B * H, t, D) for a in (q, k, v, do))
    scale = 1.0 / math.sqrt(D)
    m2 = mask.reshape(B, t)
    o, lse = port.flash_fwd_reference(q3, k3, v3, scale, False, m2, 77, p)
    torch.testing.assert_close(o.reshape(B, H, t, D), ref.detach(), **TOL)
    got = port.flash_bwd_reference(q3, k3, v3, o, lse, do3, scale, False, m2,
                                   77, p)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.reshape(B, H, t, D), w, atol=2e-5,
                                   rtol=2e-5)


def test_sdpa_entry_argument_handling():
    """The layers' entry: dropout only in training, flash where its
    domain admits the call (the plain versions here), composed
    otherwise, the same mask from the same seed on both routes."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(64, seed=9))
    ev = port.scaled_dot_product_attention(q, k, v, dropout_p=0.5,
                                           training=False)
    torch.testing.assert_close(ev, port.sdpa_reference(q, k, v), **TOL)
    tr = port.scaled_dot_product_attention(q, k, v, dropout_p=0.5, seed=3)
    torch.testing.assert_close(
        tr, port.sdpa_reference(q, k, v, dropout_p=0.5, seed=3), **TOL)
    short = q[:, :, :10]      # outside the flash domain
    out = port.scaled_dot_product_attention(short, short, short,
                                            is_causal=True)
    torch.testing.assert_close(
        out, port.sdpa_reference(short, short, short, causal=True), **TOL)


# -- the rounding of P and dS (bf16): the port rounds where the Pallas
# kernel does, so almost every element of o, dq, dk and dv is the same
# bf16 number. The rest differ by one bf16 step at their row's scale
# (the largest |want| of the D-vector): the sums run in another order,
# and where an intermediate P or dS rounds to the other side, the output
# moves by one step of that term, which can be several steps of an
# element that cancels to a small value.
def _bf16_step(x):
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


# An exact zero of the reference can come out as f32 noise: under the
# causal mask row 0 of dq is p (dP - delta) with p = 1 and dP = delta,
# which cancels exactly in one order of f32 sums and leaves ~1e-7 in
# another. Gaps below 2**-20 are that noise, not a rounding.
F32_NOISE = 2.0 ** -20


def _assert_rounds_alike(got, want):
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        gap = np.abs(g - w)
        step = _bf16_step(np.abs(w).max(-1, keepdims=True))
        assert np.all(gap <= np.maximum(step, F32_NOISE)), \
            (name, float(gap.max()))
        assert (g != w).mean() <= 0.01, (name, float((g != w).mean()))


def _small_inputs(t, seed=2):
    rng = np.random.RandomState(seed)
    return [rng.randn(1, 2, t, D).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [128, 192, 1024])
def test_flash_bf16_rounds_like_pallas_interpret(t, causal):
    """T = 192: the reference's 64-wide key blocks; T = 1024: two
    512-wide blocks, where P is rounded against the running max after
    each; T = 128: one block."""
    q, k, v, do = _small_inputs(t)
    got = _port_variant(q, k, v, do, causal, None, 0.0, 0, torch.bfloat16)
    want = _jax_variant(q, k, v, do, causal, None, 0.0, 0, jnp.bfloat16)
    _assert_rounds_alike(got, want)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_rounds_at_the_reference_block_override(causal,
                                                           monkeypatch):
    """With the reference's block knobs at 64, its kernels round P at
    64-key blocks of T = 1024 (sixteen, not two), and so does the
    port."""
    monkeypatch.setenv("PADDLE_TPU_FLASH_BLOCK_Q", "64")
    monkeypatch.setenv("PADDLE_TPU_FLASH_BLOCK_K", "64")
    assert port.ref_block(1024) == 64
    q, k, v, do = _small_inputs(1024)
    got = _port_variant(q, k, v, do, causal, None, 0.0, 0, torch.bfloat16)
    want = _jax_variant(q, k, v, do, causal, None, 0.0, 0, jnp.bfloat16)
    _assert_rounds_alike(got, want)


def test_ref_block_follows_the_override_where_it_divides(monkeypatch):
    from paddle_tpu.ops.pallas_attention import _auto_block
    monkeypatch.setenv("PADDLE_TPU_FLASH_BLOCK_K", "128")
    for t in (128, 192, 384, 1024):
        assert port.ref_block(t) == _auto_block(t, "PADDLE_TPU_FLASH_BLOCK_K")
    assert port.ref_block(192) == 64 and port.ref_block(1024) == 128


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_mask_dropout_rounds_like_pallas_interpret(causal):
    q, k, v, do = _small_inputs(128, seed=3)
    mask = _pad_mask(128, seed=3)[:1]
    got = _port_variant(q, k, v, do, causal, mask, 0.1, 99, torch.bfloat16)
    want = _jax_variant(q, k, v, do, causal, mask, 0.1, 99, jnp.bfloat16)
    _assert_rounds_alike(got, want)


@pytest.mark.parametrize("t,want", [(64, 64), (192, 64), (128, 128),
                                    (384, 128), (256, 256), (768, 256),
                                    (1024, 512), (2048, 512)])
def test_ref_block_is_the_reference_default(t, want):
    from paddle_tpu.ops.pallas_attention import _auto_block
    assert port.ref_block(t) == want == _auto_block(t, "UNSET_FLASH_BLOCK")


def test_flash_tc_route_by_dtype_width_and_alignment():
    """bf16 at D in {64, 128} with 16-byte aligned operands takes the
    tensor-core kernels; f32, other head dims and a misaligned view take
    the SIMT kernels. Decided before the launch, from the arguments."""
    bf, f32 = torch.bfloat16, torch.float32
    aligned = (0, 4096, 1 << 20)
    for d in (64, 128):
        assert port.flash_tc_route(bf, d, aligned)
        assert not port.flash_tc_route(f32, d, aligned)
    for d in (8, 96, 256):
        assert not port.flash_tc_route(bf, d, aligned)
    flat = torch.zeros(64 * 64 + 4, dtype=bf)
    view = flat[4:].view(1, 64, 64)       # 8 bytes past an aligned start
    assert view.is_contiguous() and view.data_ptr() % 16 == 8
    assert not port.flash_tc_route(bf, 64, (0, view.data_ptr(), 4096))

"""Fused decoder sub-blocks in the port (paddle_tpu_torch/ops/
fused_block.py) against the JAX package's composed references and its
Pallas kernels in interpret mode, on the same numpy inputs, for ragged
row counts. On the CPU the port's entry points run their plain
versions; the CUDA kernels are held to those on the card
(chip_smoke.py)."""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import pallas_block as pb
from paddle_tpu_torch.ops import fused_block as port

# float32 throughout; the sums run in another order than XLA's
TOL = dict(atol=1e-5, rtol=1e-5)
D, I = 128, 512
U32 = 2.0 ** -24     # unit roundoff of float32


def _sum_tol(k, terms_abs):
    """Tolerance of a float32 sum of k products whose absolute values add
    up to `terms_abs`, when two implementations add them in different
    orders: each is within about sqrt(k) * u * sum|a_i b_i| of the exact
    sum (the probabilistic bound of a recursive sum; the worst case is
    k * u), and 4x that covers both sides and the blocked orders of
    multi-threaded GEMMs."""
    return 4.0 * math.sqrt(k) * U32 * terms_abs


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")


def _out_ln_inputs(m, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(m, D).astype(np.float32) * 0.1,
            rng.randn(D, D).astype(np.float32) * 0.05,
            rng.randn(D).astype(np.float32) * 0.1,
            rng.randn(m, D).astype(np.float32),
            (rng.rand(D) + 0.5).astype(np.float32),
            rng.randn(D).astype(np.float32)]


def _ffn_inputs(m, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(m, D).astype(np.float32),
            rng.randn(D, I).astype(np.float32) * 0.05,
            rng.randn(I).astype(np.float32) * 0.1,
            rng.randn(I, D).astype(np.float32) * 0.05,
            rng.randn(D).astype(np.float32) * 0.1,
            rng.randn(m, D).astype(np.float32)]


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


SEED = jnp.zeros((1,), jnp.int32)


@pytest.mark.parametrize("m", [8, 20])
def test_fused_out_ln_matches_composed_reference(m):
    a = _out_ln_inputs(m)
    z, h = port.fused_out_ln(*_t(a))
    zj, hj = pb.out_ln_reference(*_j(a), SEED, 0.0, 1e-5)
    np.testing.assert_allclose(z.numpy(), np.asarray(zj), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), **TOL)


@pytest.mark.parametrize("m", [8, 20])
def test_fused_out_ln_matches_pallas_interpret(m, interpret):
    a = _out_ln_inputs(m, seed=1)
    assert pb.can_use_fused_out_ln(m, D, D, 4)
    z, h = port.fused_out_ln(*_t(a))
    zj, hj = pb.fused_out_ln(*_j(a), SEED, 0.0, 1e-5)
    np.testing.assert_allclose(z.numpy(), np.asarray(zj), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), **TOL)


@pytest.mark.parametrize("m", [8, 20])
def test_fused_ffn_ln_matches_composed_reference(m):
    """Both sides are float32 GEMM pairs whose second product sums
    I = 512 terms per output. How a CPU GEMM blocks that sum depends on
    the library and on the threads it finds, so the two results are held
    to the tolerance that the sum length gives (_sum_tol, about 2e-5
    here, where a fixed 1e-5 failed once in a loaded six-worker run), and
    each is also held to the float64 result of the same chain."""
    a = _ffn_inputs(m)
    ones, zeros = np.ones(D, np.float32), np.zeros(D, np.float32)
    got = port.fused_ffn_ln(*_t(a)).numpy()
    want = np.asarray(pb.ffn_ln_reference(
        *_j(a), jnp.asarray(ones), jnp.asarray(zeros), SEED, "gelu_tanh",
        "none", 0.0, 1e-5))
    x, w1, b1, w2, b2, res = (v.astype(np.float64) for v in a)
    pre = x @ w1 + b1
    hid = 0.5 * pre * (1 + np.tanh(0.7978845608028654
                                   * (pre + 0.044715 * pre ** 3)))
    exact = hid @ w2 + b2 + res
    atol = _sum_tol(I, float((np.abs(hid) @ np.abs(w2)).max()))
    assert atol < 5e-5
    np.testing.assert_allclose(got, exact, atol=atol, rtol=1e-6)
    np.testing.assert_allclose(want, exact, atol=atol, rtol=1e-6)
    np.testing.assert_allclose(got, want, atol=atol, rtol=1e-5)


@pytest.mark.parametrize("m", [8, 20])
def test_fused_ffn_ln_matches_pallas_interpret(m, interpret):
    a = _ffn_inputs(m, seed=2)
    assert pb.can_use_fused_ffn_ln(m, D, I, 4)
    ones, zeros = jnp.ones((D,), jnp.float32), jnp.zeros((D,), jnp.float32)
    got = port.fused_ffn_ln(*_t(a))
    want = pb.fused_ffn_ln(*_j(a), ones, zeros, SEED, "gelu_tanh", "none",
                           0.0, 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gelu_tanh_matches_pallas_formula():
    from paddle_tpu.ops.pallas_ffn import _gelu_tanh
    x = np.linspace(-8, 8, 4001).astype(np.float32)
    np.testing.assert_allclose(port.gelu_tanh(torch.from_numpy(x)).numpy(),
                               np.asarray(_gelu_tanh(jnp.asarray(x))),
                               atol=1e-6, rtol=1e-6)


def _ln_vecs(seed=3):
    rng = np.random.RandomState(seed)
    return ((rng.rand(D) + 0.5).astype(np.float32),
            rng.randn(D).astype(np.float32))


@pytest.mark.parametrize("kw", [dict(p=0.1), dict(act="gelu"),
                                dict(act="relu"), dict(norm="pre"),
                                dict(norm="post")])
def test_unported_variants_raise(kw):
    """The variants that raised NotImplementedError until the BERT slice
    (dropout, gelu, relu, pre/post norm) now run, and agree with the JAX
    composed reference under the same int32 seed; what still raises is
    an unknown activation or norm, and a norm without its LN vectors."""
    a = _ffn_inputs(4)
    ln = _ln_vecs()
    full = dict(act="gelu_tanh", norm="none", p=0.0)
    full.update(kw)
    got = port.fused_ffn_ln(*_t(a), *_t(ln), eps=1e-5, seed=21, **full)
    want = pb.ffn_ln_reference(
        *_j(a), *_j(ln), jnp.asarray([21], jnp.int32), full["act"],
        full["norm"], full["p"], 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    if set(kw) == {"p"}:
        o = _out_ln_inputs(4)
        z, h = port.fused_out_ln(*_t(o), p=0.1, seed=21)
        zj, hj = pb.out_ln_reference(*_j(o), jnp.asarray([21], jnp.int32),
                                     0.1, 1e-5)
        np.testing.assert_allclose(z.numpy(), np.asarray(zj), atol=2e-5,
                                   rtol=2e-5)
        np.testing.assert_allclose(h.numpy(), np.asarray(hj), atol=2e-5,
                                   rtol=2e-5)
    with pytest.raises(ValueError, match="gelu/gelu_tanh/relu"):
        port.fused_ffn_ln(*_t(a), act="swish")
    with pytest.raises(ValueError, match="none/pre/post"):
        port.fused_ffn_ln(*_t(a), norm="both")
    with pytest.raises(ValueError, match="needs ln_s"):
        port.fused_ffn_ln(*_t(a), norm="post")


def test_other_devices_raise():
    a = [torch.empty(t.shape, device="meta") for t in _t(_out_ln_inputs(4))]
    with pytest.raises(ValueError, match="no kernel"):
        port.fused_out_ln(*a)
    f = [torch.empty(t.shape, device="meta") for t in _t(_ffn_inputs(4))]
    with pytest.raises(ValueError, match="no kernel"):
        port.fused_ffn_ln(*f)


@pytest.mark.parametrize("m,k,n", [(8, 2048, 2048), (1, 2048, 2048),
                                   (20, 128, 128), (256, 2048, 2048),
                                   (3, 96, 64)])
def test_out_ln_split_k_covers_k(m, k, n):
    """The split depth is a multiple of the kernel's k stage, the
    splits cover K, and only a card-starving tile count splits (on a
    card of 132 SMs, the H100 SXM's count)."""
    kc = port.out_ln_split_k(m, k, n, 132)
    splits = math.ceil(k / kc)
    assert kc % 32 == 0 and kc * splits >= k and kc * (splits - 1) < k
    tiles = math.ceil(m / 32) * math.ceil(n / 64)
    if tiles >= 132:
        assert splits == 1
    if (m, k, n) == (8, 2048, 2048):
        assert splits == 8      # 32 output tiles x 8 splits = 256 blocks


def test_ffn_block_i_by_rows():
    assert port.ffn_block_i(8) == 64 and port.ffn_block_i(64) == 64
    assert port.ffn_block_i(65) == 128 and port.ffn_block_i(256) == 128


# -- gradients: the port's autograd Functions against jax.vjp of the JAX
# custom-VJP functions (interpret mode). Both backward passes are the
# same composed f32 recompute, so f32 agrees to summation order; in
# bf16 the inputs and cotangents are the same bf16 numbers and each
# gradient is rounded once to bf16, so they agree to a bf16 step or two
# (2**-8 relative) where the f32 sums differ in their last bits.
GRAD_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
            torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _grad_case(arrs, n_ln, dtype):
    """Torch leaves (the first len(arrs) - n_ln in `dtype`, the LN
    vectors f32) and the same values as jax arrays."""
    n = len(arrs) - n_ln
    ts = [torch.from_numpy(a).to(dtype if i < n else torch.float32)
          .requires_grad_() for i, a in enumerate(arrs)]
    js = [jnp.asarray(t.detach().float().numpy(), _JDT[dtype] if i < n
                      else jnp.float32) for i, t in enumerate(ts)]
    return ts, js


def _assert_grads(got, want, dtype):
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == dtype or g.dtype == torch.float32
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32),
                                   err_msg=f"input {i}", **GRAD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [8, 20])
def test_fused_out_ln_grads_match_jax_vjp(m, dtype, interpret):
    arrs = _out_ln_inputs(m, seed=5)
    rng = np.random.RandomState(6)
    dz, dh = (rng.randn(m, D).astype(np.float32) for _ in range(2))
    ts, js = _grad_case(arrs, 2, dtype)
    z, h = port.fused_out_ln(*ts)
    assert z.dtype == dtype and h.dtype == dtype
    cz, ch = (torch.from_numpy(c).to(dtype) for c in (dz, dh))
    got = torch.autograd.grad((z, h), ts, (cz, ch))
    (zj, hj), vjp = jax.vjp(
        lambda *a: pb.fused_out_ln(*a, SEED, 0.0, 1e-5), *js)
    want = vjp((jnp.asarray(cz.float().numpy(), _JDT[dtype]),
                jnp.asarray(ch.float().numpy(), _JDT[dtype])))
    _assert_grads(got, want, dtype)
    for t, g in zip(ts, got):
        assert g.dtype == t.dtype


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [8, 20])
def test_fused_ffn_ln_grads_match_jax_vjp(m, dtype, interpret):
    arrs = _ffn_inputs(m, seed=7)
    dy = np.random.RandomState(8).randn(m, D).astype(np.float32)
    ts, js = _grad_case(arrs, 0, dtype)
    out = port.fused_ffn_ln(*ts)
    assert out.dtype == dtype
    cy = torch.from_numpy(dy).to(dtype)
    got = torch.autograd.grad(out, ts, cy)
    ones, zeros = jnp.ones((D,), jnp.float32), jnp.zeros((D,), jnp.float32)
    _, vjp = jax.vjp(lambda *a: pb.fused_ffn_ln(
        *a, ones, zeros, SEED, "gelu_tanh", "none", 0.0, 1e-5), *js)
    want = vjp(jnp.asarray(cy.float().numpy(), _JDT[dtype]))[:6]
    _assert_grads(got, want, dtype)
    for t, g in zip(ts, got):
        assert g.dtype == t.dtype


def test_out_ln_split_k_follows_the_sm_count():
    """The SM count is the card's, passed in: fewer SMs, fewer splits."""
    assert math.ceil(2048 / port.out_ln_split_k(8, 2048, 2048, 132)) == 8
    assert math.ceil(2048 / port.out_ln_split_k(8, 2048, 2048, 64)) == 4


@pytest.mark.parametrize("dtype,widths,ptrs,want", [
    (torch.bfloat16, (2048, 8192), (0, 4096), True),   # GPT-3 XL FFN
    (torch.bfloat16, (2048, 2048), (256,), True),      # its out-projection
    (torch.bfloat16, (768, 3072), (), True),           # BERT-base
    (torch.bfloat16, (128, 512), (), True),            # the tests' widths
    (torch.bfloat16, (192, 64), (), True),             # 64, not 128
    (torch.float32, (2048, 8192), (0,), False),        # f32 stays SIMT
    (torch.bfloat16, (200, 300), (), False),           # ragged widths
    (torch.bfloat16, (160, 200), (), False),
    (torch.bfloat16, (2048, 96), (), False),
    (torch.bfloat16, (0, 128), (), False),
    (torch.bfloat16, (2048, 8192), (0, 8), False),     # a misaligned view
    (torch.bfloat16, (2048, 8192), (2,), False),
    (torch.float16, (2048, 8192), (), False),
])
def test_tc_route_picks_by_dtype_width_and_alignment(dtype, widths, ptrs,
                                                     want):
    assert port.tc_route(dtype, widths, ptrs) is want


@pytest.mark.parametrize("dtype,m,widths,ptrs,want", [
    (torch.float32, 128, (2048, 2048), (0, 256), True),   # prefill bucket
    (torch.float32, 256, (2048, 8192), (4096,), True),    # GPT-3 XL FFN
    (torch.float32, 256, (8192, 2048), (), True),
    (torch.float32, 2048, (768, 768), (), True),          # BERT-base
    (torch.float32, 2048, (768, 3072), (0, 16), True),
    (torch.float32, 200, (128, 512), (), True),           # ragged M
    (torch.float32, 8, (2048, 8192), (), False),          # decode
    (torch.float32, 64, (2048, 2048), (), False),         # short prefill
    (torch.float32, 127, (768, 3072), (), False),
    (torch.bfloat16, 2048, (768, 3072), (), False),       # bf16: tc
    (torch.float16, 2048, (768, 3072), (), False),
    (torch.float32, 256, (200, 300), (), False),          # ragged widths
    (torch.float32, 256, (2048, 96), (), False),
    (torch.float32, 256, (0, 128), (), False),
    (torch.float32, 256, (2048, 8192), (0, 8), False),    # 8 bytes off
    (torch.float32, 2048, (768, 3072), (4,), False),
])
def test_ffma_route_picks_by_dtype_rows_width_and_alignment(dtype, m, widths,
                                                            ptrs, want):
    assert port.ffma_route(dtype, m, widths, ptrs) is want


_SMR = port._STREAM_MAX_ROWS


@pytest.mark.parametrize("dtype,m,widths,ptrs,want", [
    (torch.float32, 8, (2048, 2048), (0, 256), True),     # decode out_ln
    (torch.float32, 8, (2048, 8192), (4096,), True),      # decode FFN
    (torch.float32, 8, (8192, 2048), (), True),
    (torch.float32, 1, (768, 3072), (), True),            # one row
    (torch.float32, 16, (2048, 8192), (), True),          # prefill bucket
    (torch.float32, _SMR, (2048, 8192), (), True),        # the limit
    (torch.float32, _SMR + 1, (2048, 8192), (), False),   # then SIMT ...
    (torch.float32, 128, (2048, 8192), (), False),        # ... and FFMA
    (torch.float32, 0, (2048, 8192), (), False),
    (torch.bfloat16, 8, (2048, 8192), (), False),         # bf16: tc
    (torch.float16, 8, (2048, 8192), (), False),
    (torch.float32, 8, (200, 300), (), False),            # ragged widths
    (torch.float32, 8, (2048, 96), (), False),
    (torch.float32, 8, (0, 128), (), False),
    (torch.float32, 8, (2048, 8192), (0, 8), False),      # 8 bytes off
    (torch.float32, 8, (768, 3072), (4,), False),
])
def test_stream_route_picks_by_dtype_rows_width_and_alignment(dtype, m,
                                                              widths, ptrs,
                                                              want):
    assert port.stream_route(dtype, m, widths, ptrs) is want


@pytest.mark.parametrize("m,k,n,sms", [
    (8, 2048, 2048, 132), (8, 2048, 8192, 132), (8, 8192, 2048, 132),
    (1, 2048, 2048, 132), (3, 768, 3072, 132), (16, 2048, 8192, 132),
    (_SMR, 8192, 2048, 132), (8, 768, 768, 132), (8, 3072, 768, 132),
    (8, 2048, 2048, 1), (8, 2048, 2048, 1000), (5, 640, 320, 7),
])
def test_stream_splits_cover_k(m, k, n, sms):
    """The splits cut K's stages of 64 into ranges of ceil(stages /
    splits) that cover K with none left empty, each of at least two
    stages once K is split, and bring the grid near two blocks an SM."""
    splits = port.stream_splits(m, k, n, sms)
    stages = math.ceil(k / 64)
    per = math.ceil(stages / splits)
    assert splits >= 1
    assert splits * per >= stages > (splits - 1) * per
    assert splits == 1 or per >= 2
    tiles = math.ceil(m / port.stream_rows(m)) * (n // 32)
    assert splits == 1 or tiles * splits <= 2 * sms + tiles / 2


@pytest.mark.parametrize("m,k,n,want_splits,want_blocks", [
    (8, 2048, 2048, 4, 256),    # fused_out_ln at decode
    (8, 2048, 8192, 1, 256),    # the FFN's first product
    (8, 8192, 2048, 4, 256),    # the FFN's second product
    (16, 2048, 2048, 4, 256),
    (64, 2048, 8192, 1, 1024),  # four row tiles: no split
])
def test_stream_splits_block_count_at_132_sms(m, k, n, want_splits,
                                              want_blocks):
    splits = port.stream_splits(m, k, n, 132)
    blocks = math.ceil(m / port.stream_rows(m)) * (n // 32) * splits
    assert (splits, blocks) == (want_splits, want_blocks)


@pytest.mark.parametrize("k", [32, 64, 127])
def test_stream_splits_k_shorter_than_two_stages(k):
    """K of at most one stage, or under two, is never split."""
    assert port.stream_splits(8, k, 2048, 132) == 1


@pytest.mark.parametrize("m,want", [(1, 4), (4, 4), (5, 8), (8, 8),
                                    (9, 16), (16, 16), (64, 16)])
def test_stream_rows_by_m(m, want):
    assert port.stream_rows(m) == want


def test_workspace_is_kept_per_stream_and_grown():
    """One tensor per (device, stream, name), reused while large enough,
    replaced by a larger one when short; int32 ones start at zero."""
    from paddle_tpu_torch.ops import _launch
    dev = torch.device("cpu")
    a = _launch.workspace(dev, 11, "t_test", 8, torch.int32)
    assert a.dtype == torch.int32 and not a.any() and a.numel() == 8
    assert _launch.workspace(dev, 11, "t_test", 4, torch.int32) is a
    b = _launch.workspace(dev, 12, "t_test", 4, torch.int32)
    assert b is not a
    c = _launch.workspace(dev, 11, "t_test", 16, torch.int32)
    assert c.numel() == 16 and not c.any()
    assert _launch.workspace(dev, 11, "t_test", 16, torch.int32) is c
    f = _launch.workspace(dev, 11, "f_test", 5)
    assert f.dtype == torch.float32 and f.numel() == 5
    for key in [k for k in _launch._WORK if k[2] in ("t_test", "f_test")]:
        del _launch._WORK[key]


@pytest.mark.parametrize("m,n,sms,want", [
    (2048, 3072, 132, (128, 64)),    # BERT FFN up: 97% of 3 waves
    (2048, 768, 132, (64, 64)),      # BERT out-projection, FFN down
    (256, 8192, 132, (128, 64)),     # GPT-3 XL prefill FFN up
    (256, 2048, 132, (64, 64)),      # its out-projection, FFN down
    (128, 2048, 132, (64, 64)),      # the smallest bucket: under-filled
    (200, 512, 132, (64, 64)),       # ragged M
    (8192, 768, 132, (128, 64)),
    (8192, 3072, 132, (128, 128)),   # 1536 tiles: 97% of 6 waves
    (130, 64, 1, (128, 128)),        # one SM: ragged rows and columns
    (200, 192, 4, (64, 64)),
])
def test_ffma_tiles_cover_the_output(m, n, sms, want):
    """One of the three tiles: the largest whose tiles fill at least 90%
    of the waves of resident blocks they take (sms x its blocks an SM),
    else the smallest; its grid covers every element of m x n."""
    bm, bn = port.ffma_tiles(m, n, sms)
    assert (bm, bn) == want and (bm, bn) in port._FFMA_TILES
    rows, cols = math.ceil(m / bm), math.ceil(n / bn)
    assert rows * bm >= m > (rows - 1) * bm
    assert cols * bn >= n > (cols - 1) * bn

    def fill(k):
        (r, c), per_sm = port._FFMA_TILES[k], port._FFMA_BLOCKS[k]
        tiles, wave = math.ceil(m / r) * math.ceil(n / c), sms * per_sm
        return tiles / (wave * math.ceil(tiles / wave))

    k = port._FFMA_TILES.index((bm, bn))
    assert all(fill(j) < port._FFMA_FILL for j in range(k))
    assert fill(k) >= port._FFMA_FILL or k == len(port._FFMA_TILES) - 1


@pytest.mark.parametrize("m", [8, 20])
def test_bf16_ffn_ln_matches_pallas_interpret(m, interpret):
    """bf16 through the port and through the Pallas kernel in interpret
    mode. The reference rounds hid to x's type before the second product
    (pallas_block.py:_ffn_ln_kernel); so does the port. Both then sum the
    same bf16 products in f32 and round once, so an element may differ
    by one bf16 step of |want| (where the two f32 sums straddle a
    rounding boundary) and at most 1% of the elements may differ at all.
    Without the rounding of hid, 24% (m=8) and 21% (m=20) differ."""
    f = _ffn_inputs(m, seed=10)
    ts, js = _grad_case(f, 0, torch.bfloat16)
    ones, zeros = jnp.ones((D,), jnp.float32), jnp.zeros((D,), jnp.float32)
    assert pb.can_use_fused_ffn_ln(m, D, I, 2)
    got = port.fused_ffn_ln(*ts).detach().float().numpy()
    want = np.asarray(pb.fused_ffn_ln(*js, ones, zeros, SEED, "gelu_tanh",
                                      "none", 0.0, 1e-5), np.float32)
    diff = np.abs(got - want)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                  - 7)                       # bf16: 8 significant bits
    assert (diff <= ulp).all(), diff.max()
    assert (diff > 0).mean() <= 0.01, (diff > 0).mean()


@pytest.mark.parametrize("m", [8, 20])
def test_bf16_forward_matches_composed_reference(m):
    """bf16 activations/weights with f32 LN vectors, the training path's
    types: z and h in bf16 against the JAX composed chain on the same
    bf16 numbers (one rounding of each output)."""
    a = _out_ln_inputs(m, seed=9)
    ts, js = _grad_case(a, 2, torch.bfloat16)
    z, h = port.fused_out_ln(*ts)
    zj, hj = pb.out_ln_reference(*js, SEED, 0.0, 1e-5)
    for g, w in ((z, zj), (h, hj)):
        np.testing.assert_allclose(g.detach().float().numpy(),
                                   np.asarray(w, np.float32),
                                   atol=1e-2, rtol=1e-2)
    f = _ffn_inputs(m, seed=10)
    ts, js = _grad_case(f, 0, torch.bfloat16)
    ones, zeros = jnp.ones((D,), jnp.float32), jnp.zeros((D,), jnp.float32)
    want = pb.ffn_ln_reference(*js, ones, zeros, SEED, "gelu_tanh", "none",
                               0.0, 1e-5)
    np.testing.assert_allclose(port.fused_ffn_ln(*ts).detach().float()
                               .numpy(), np.asarray(want, np.float32),
                               atol=1e-2, rtol=1e-2)


# -- the BERT variants: dropout (the unsalted counter hash over the
# unpadded (M, C) ids), pre/post norm, gelu / relu. Same numpy inputs and
# the same int32 seed through both packages; the JAX side is the Pallas
# kernel in interpret mode, whose row padding to 128 must not move the
# mask (ragged M = 20).
VARIANTS = [("gelu", "post", 0.1), ("gelu", "post", 0.0),
            ("relu", "post", 0.1), ("gelu", "pre", 0.1),
            ("gelu_tanh", "pre", 0.0), ("relu", "none", 0.3),
            ("gelu", "none", 0.0)]
SEED_I = 20240917
JSEED = jnp.asarray([SEED_I], jnp.int32)
# f32 sums in another order, the erf polynomial against lax.erf in the
# reference's backward (< 1.5e-7), a division by 1 - p on both sides
VTOL = dict(atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("act,norm,p", VARIANTS)
@pytest.mark.parametrize("m", [8, 20])
def test_ffn_ln_variants_match_pallas_interpret(m, act, norm, p, interpret):
    a, ln = _ffn_inputs(m, seed=11), _ln_vecs(12)
    assert pb.can_use_fused_ffn_ln(m, D, I, 4, norm == "pre")
    got = port.fused_ffn_ln(*_t(a), *_t(ln), act, norm, p, 1e-12, SEED_I)
    want = pb.fused_ffn_ln(*_j(a), *_j(ln), JSEED, act, norm, p, 1e-12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VTOL)


@pytest.mark.parametrize("p", [0.1, 0.5])
@pytest.mark.parametrize("m", [8, 20])
def test_out_ln_dropout_matches_pallas_interpret(m, p, interpret):
    a = _out_ln_inputs(m, seed=13)
    z, h = port.fused_out_ln(*_t(a), p=p, eps=1e-12, seed=SEED_I)
    zj, hj = pb.fused_out_ln(*_j(a), JSEED, p, 1e-12)
    np.testing.assert_allclose(z.numpy(), np.asarray(zj), **VTOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), **VTOL)


@pytest.mark.parametrize("m", [8, 20])
def test_block_dropout_masks_are_bit_equal(m, interpret):
    """With a zero residual the (M, C) output is zero exactly where the
    mask dropped: the same pattern in the port, in the Pallas kernel and
    in keep_mask."""
    from paddle_tpu_torch.ops.fused_residual import keep_mask
    p = 0.25
    keep = keep_mask(SEED_I, m, D, p).numpy()
    a = _out_ln_inputs(m, seed=14)
    a[3] = np.zeros_like(a[3])
    z, _ = port.fused_out_ln(*_t(a), p=p, seed=SEED_I)
    zj, _ = pb.fused_out_ln(*_j(a), JSEED, p, 1e-5)
    np.testing.assert_array_equal(z.numpy() != 0, keep)
    np.testing.assert_array_equal(np.asarray(zj) != 0, keep)
    f = _ffn_inputs(m, seed=15)
    f[5] = np.zeros_like(f[5])
    out = port.fused_ffn_ln(*_t(f), act="gelu", p=p, seed=SEED_I)
    ones, zeros = jnp.ones((D,)), jnp.zeros((D,))
    outj = pb.fused_ffn_ln(*_j(f), ones, zeros, JSEED, "gelu", "none", p,
                           1e-5)
    np.testing.assert_array_equal(out.numpy() != 0, keep)
    np.testing.assert_array_equal(np.asarray(outj) != 0, keep)


def test_gelu_erf_poly_matches_the_reference_polynomial():
    """The port's gelu is the reference's A&S 7.1.26 polynomial
    (pallas_ffn._gelu_exact), not erf itself: the two polynomials agree
    to float32 rounding, and both stay within 1.5e-7 * |x| / 2 + rounding
    of the exact gelu."""
    from paddle_tpu.ops.pallas_ffn import _gelu_exact
    x = np.linspace(-8, 8, 8001).astype(np.float32)
    got = port.gelu_erf_poly(torch.from_numpy(x)).numpy()
    want = np.asarray(_gelu_exact(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1.5e-7, rtol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x).double()).numpy()
    assert np.abs(got - exact).max() < 1.5e-7 * 8 / 2 + 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act,norm,p", [("gelu", "post", 0.1),
                                        ("relu", "pre", 0.1),
                                        ("gelu", "none", 0.2)])
def test_ffn_ln_variant_grads_match_jax_vjp(act, norm, p, dtype, interpret):
    """The mask is replayed in the gradients: every input's gradient
    (the LN vectors' too) against jax.vjp of the Pallas function under
    the same seed."""
    m = 20
    arrs = _ffn_inputs(m, seed=16) + list(_ln_vecs(17))
    dy = np.random.RandomState(18).randn(m, D).astype(np.float32)
    ts, js = _grad_case(arrs, 2, dtype)
    out = port.fused_ffn_ln(*ts, act, norm, p, 1e-5, SEED_I)
    assert out.dtype == dtype
    cy = torch.from_numpy(dy).to(dtype)
    n = 6 if norm == "none" else 8
    got = torch.autograd.grad(out, ts[:n], cy)
    _, vjp = jax.vjp(lambda *a: pb.fused_ffn_ln(
        *a, JSEED, act, norm, p, 1e-5), *js)
    want = vjp(jnp.asarray(cy.float().numpy(), _JDT[dtype]))[:n]
    tol = dict(GRAD_TOL[dtype])
    if dtype == torch.float32:
        tol = dict(atol=1e-4, rtol=1e-4)   # dW sums over M rows / (1 - p)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32),
                                   err_msg=f"input {i}", **tol)
    if norm == "none":      # the unused LN vectors get no gradient
        assert torch.autograd.grad(
            port.fused_ffn_ln(*ts, act, norm, p, 1e-5, SEED_I), ts[6:], cy,
            allow_unused=True) == (None, None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_out_ln_dropout_grads_match_jax_vjp(dtype, interpret):
    m, p = 20, 0.1
    arrs = _out_ln_inputs(m, seed=19)
    rng = np.random.RandomState(20)
    dz, dh = (rng.randn(m, D).astype(np.float32) for _ in range(2))
    ts, js = _grad_case(arrs, 2, dtype)
    z, h = port.fused_out_ln(*ts, p, 1e-5, SEED_I)
    cz, ch = (torch.from_numpy(c).to(dtype) for c in (dz, dh))
    got = torch.autograd.grad((z, h), ts, (cz, ch))
    _, vjp = jax.vjp(lambda *a: pb.fused_out_ln(*a, JSEED, p, 1e-5), *js)
    want = vjp((jnp.asarray(cz.float().numpy(), _JDT[dtype]),
                jnp.asarray(ch.float().numpy(), _JDT[dtype])))
    tol = GRAD_TOL[dtype] if dtype == torch.bfloat16 \
        else dict(atol=1e-4, rtol=1e-4)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32),
                                   err_msg=f"input {i}", **tol)

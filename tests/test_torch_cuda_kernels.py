"""The port's CUDA kernels against their plain PyTorch versions on the
card, at edge shapes the serving and training paths can produce: ragged
row counts (M = 1, not a multiple of the 32-row tile), widths that are
not multiples of the column tiles, split-K and unsplit launches,
page-table rows padded with the trash page, float32 and bfloat16 caches
and sub-block inputs; the three flash kernels at every head-dim bucket
(D <= 64, <= 128, <= 256), causal or not, S != T, float32 and bfloat16;
the layer-norm and dropout+residual+layer-norm kernels at odd row counts,
widths that are not multiples of 4 or 128 (the scalar path) and the
widest row (C = 16384), with bit-equal dropout masks; and the dropout,
pre/post-norm, gelu/relu and padding-mask variants of the sub-block and
flash kernels.

Needs a CUDA card: each test skips without one (the `dev` fixture
decides, at run time). On the card, run

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py

(--noconftest: the suite's conftest pins JAX, which the card's host
does not need). chip_smoke.py checks the same kernels at the GPT-3 XL
shapes."""
import math

import pytest
import torch


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _g(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,ps", [(64, 8), (128, 16), (96, 32)])
def test_paged_attention_kernel_matches_plain(dev, cache, d, ps):
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops.paged_attention import (
        paged_attention_decode, paged_attention_reference)
    S, H, M = 5, 3, 6
    P = S * M
    g = _g(0)
    q = torch.randn(S, H, d, generator=g, device=dev)
    k = torch.randn(P + 1, ps, H, d, generator=g, device=dev).to(cache)
    v = torch.randn(P + 1, ps, H, d, generator=g, device=dev).to(cache)
    ctx = torch.tensor([1, ps, ps + 1, 3 * ps - 2, M * ps], dtype=torch.int32,
                       device=dev)
    pt = torch.randperm(P, generator=g, device=dev).reshape(S, M)
    pt = pt.to(torch.int32).contiguous()
    for s in range(S):
        pt[s, math.ceil(int(ctx[s]) / ps):] = P          # trash padding
    before = _build.launch_counts().get("paged_attention", 0)
    got = paged_attention_decode(q, k, v, pt, ctx)
    want = paged_attention_reference(q, k, v, pt, ctx)
    torch.cuda.synchronize()
    assert _build.launch_counts()["paged_attention"] == before + 1
    tol = 2e-5 if cache == torch.float32 else 2e-2
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("m,k,n", [(1, 256, 64), (8, 2048, 2048),
                                   (37, 160, 200), (300, 128, 96)])
def test_fused_out_ln_kernel_matches_plain(dev, m, k, n):
    from paddle_tpu_torch.ops.fused_block import (fused_out_ln,
                                                  out_ln_reference)
    g = _g(1)
    args = (torch.randn(m, k, generator=g, device=dev),
            torch.randn(k, n, generator=g, device=dev) * 0.05,
            torch.randn(n, generator=g, device=dev) * 0.1,
            torch.randn(m, n, generator=g, device=dev),
            1 + 0.1 * torch.randn(n, generator=g, device=dev),
            0.1 * torch.randn(n, generator=g, device=dev))
    z, h = fused_out_ln(*args)
    zr, hr = out_ln_reference(*args)
    torch.testing.assert_close(z, zr, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(h, hr, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("m,h,i", [(1, 128, 512), (8, 256, 1024),
                                   (70, 200, 300), (33, 128, 96)])
def test_fused_ffn_ln_kernel_matches_plain(dev, m, h, i):
    from paddle_tpu_torch.ops.fused_block import (ffn_ln_reference,
                                                  fused_ffn_ln)
    g = _g(2)
    args = (torch.randn(m, h, generator=g, device=dev),
            torch.randn(h, i, generator=g, device=dev) * 0.05,
            torch.randn(i, generator=g, device=dev) * 0.1,
            torch.randn(i, h, generator=g, device=dev) * 0.05,
            torch.randn(h, generator=g, device=dev) * 0.1,
            torch.randn(m, h, generator=g, device=dev))
    got = fused_ffn_ln(*args)
    want = ffn_ln_reference(*args)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_fused_kernels_are_deterministic(dev):
    """Fixed reduction orders: two launches give identical bits."""
    from paddle_tpu_torch.ops.fused_block import fused_ffn_ln, fused_out_ln
    g = _g(3)
    a = torch.randn(8, 512, generator=g, device=dev)
    w = torch.randn(512, 512, generator=g, device=dev) * 0.05
    b = torch.zeros(512, device=dev)
    s = torch.ones(512, device=dev)
    w1 = torch.randn(512, 2048, generator=g, device=dev) * 0.05
    w2 = torch.randn(2048, 512, generator=g, device=dev) * 0.05
    b1 = torch.zeros(2048, device=dev)
    z1, h1 = fused_out_ln(a, w, b, a, s, b)
    z2, h2 = fused_out_ln(a, w, b, a, s, b)
    assert torch.equal(z1, z2) and torch.equal(h1, h2)
    assert torch.equal(fused_ffn_ln(a, w1, b1, w2, b, a),
                       fused_ffn_ln(a, w1, b1, w2, b, a))


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    from paddle_tpu_torch.ops.fused_block import fused_out_ln
    a = torch.randn(4, 64, device=dev, dtype=torch.bfloat16)
    w = torch.randn(64, 64, device=dev, dtype=torch.bfloat16)
    v = torch.zeros(64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32"):
        fused_out_ln(a, w, v, a, v, v)
    x = torch.randn(64, 4, device=dev).t()            # not contiguous
    w32 = torch.randn(64, 64, device=dev)
    v32 = torch.zeros(64, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        fused_out_ln(x, w32, v32, torch.zeros(4, 64, device=dev), v32, v32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,s,t,d", [(3, 64, 64, 64), (2, 128, 128, 128),
                                      (2, 64, 192, 40), (2, 192, 64, 96),
                                      (1, 128, 128, 256)])
def test_flash_kernels_match_plain(dev, dtype, causal, bh, s, t, d):
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa
    g = _g(4)
    q = torch.randn(bh, s, d, generator=g, device=dev).to(dtype)
    k = torch.randn(bh, t, d, generator=g, device=dev).to(dtype)
    v = torch.randn(bh, t, d, generator=g, device=dev).to(dtype)
    do = torch.randn(bh, s, d, generator=g, device=dev).to(dtype)
    scale = d ** -0.5
    before = _build.launch_counts()
    o, lse = fa._fwd_kernel(q, k, v, scale, causal)
    o_r, lse_r = fa.flash_fwd_reference(q, k, v, scale, causal)
    got = fa._bwd_kernels(q, k, v, o, lse, do, scale, causal)
    want = fa.flash_bwd_reference(q, k, v, o, lse, do, scale, causal)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert after[name] == before.get(name, 0) + 1
    # f32: the sums run in another order; bf16: one rounding of each
    # output to bf16 (2**-8 relative) in both
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(lse, lse_r, atol=1e-4, rtol=1e-4)
    for a, b in zip((o, *got), (o_r, *want)):
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)


def test_flash_autograd_on_the_card_is_deterministic(dev):
    """The entry point's backward runs the two kernels (no float
    atomics): two backward passes give identical bits."""
    from paddle_tpu_torch.ops.flash_attention import flash_attention
    g = _g(5)
    q, k, v = (torch.randn(1, 4, 256, 128, generator=g, device=dev)
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    do = torch.randn(1, 4, 256, 128, generator=g, device=dev).to(
        torch.bfloat16)
    runs = [torch.autograd.grad(flash_attention(q, k, v, causal=True),
                                (q, k, v), do) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("m,k,n", [(1, 256, 64), (37, 160, 200),
                                   (1024, 2048, 2048)])
def test_fused_out_ln_bf16_kernel_matches_plain(dev, m, k, n):
    from paddle_tpu_torch.ops.fused_block import (fused_out_ln,
                                                  out_ln_reference)
    g = _g(6)
    bf = torch.bfloat16
    args = (torch.randn(m, k, generator=g, device=dev).to(bf),
            (torch.randn(k, n, generator=g, device=dev) * 0.05).to(bf),
            (torch.randn(n, generator=g, device=dev) * 0.1).to(bf),
            torch.randn(m, n, generator=g, device=dev).to(bf),
            1 + 0.1 * torch.randn(n, generator=g, device=dev),
            0.1 * torch.randn(n, generator=g, device=dev))
    z, h = fused_out_ln(*args)
    zr, hr = out_ln_reference(*args)
    assert z.dtype == bf and h.dtype == bf
    # one rounding of z and h to bf16 on both sides
    torch.testing.assert_close(z.float(), zr.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(h.float(), hr.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("m,h,i", [(1, 128, 512), (70, 200, 300),
                                   (256, 512, 2048)])
def test_fused_ffn_ln_bf16_kernel_matches_plain(dev, m, h, i):
    from paddle_tpu_torch.ops.fused_block import (ffn_ln_reference,
                                                  fused_ffn_ln)
    g = _g(7)
    bf = torch.bfloat16
    args = (torch.randn(m, h, generator=g, device=dev).to(bf),
            (torch.randn(h, i, generator=g, device=dev) * 0.05).to(bf),
            (torch.randn(i, generator=g, device=dev) * 0.1).to(bf),
            (torch.randn(i, h, generator=g, device=dev) * 0.05).to(bf),
            (torch.randn(h, generator=g, device=dev) * 0.1).to(bf),
            torch.randn(m, h, generator=g, device=dev).to(bf))
    got = fused_ffn_ln(*args)
    want = ffn_ln_reference(*args)
    assert got.dtype == bf
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


def test_fused_blocks_backward_on_the_card(dev):
    """Forward through the kernels, backward the composed f32 recompute:
    the gradients equal those of the plain chain on the same inputs."""
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops.fused_block import (ffn_ln_reference,
                                                  fused_ffn_ln)
    g = _g(8)
    args = [torch.randn(40, 256, generator=g, device=dev),
            torch.randn(256, 512, generator=g, device=dev) * 0.05,
            torch.zeros(512, device=dev),
            torch.randn(512, 256, generator=g, device=dev) * 0.05,
            torch.zeros(256, device=dev),
            torch.randn(40, 256, generator=g, device=dev)]
    ts = [a.clone().requires_grad_() for a in args]
    before = _build.launch_counts().get("fused_ffn_ln", 0)
    got = torch.autograd.grad(fused_ffn_ln(*ts).sum(), ts)
    assert _build.launch_counts()["fused_ffn_ln"] == before + 1
    rs = [a.clone().requires_grad_() for a in args]
    want = torch.autograd.grad(ffn_ln_reference(*rs).sum(), rs)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


# -- layer norm, dropout + residual + layer norm (forward and backward) ----

ROW_SHAPES = [(1, 1), (3, 7), (33, 100), (304, 768), (2048, 768),
              (5, 1030), (2, 16384), (7, 16383)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,c", ROW_SHAPES)
def test_layer_norm_kernels_match_plain(dev, dtype, r, c):
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import layer_norm as ln
    g = _g(9)
    x = (torch.randn(r, c, generator=g, device=dev) * 2 + 0.5).to(dtype)
    dy = torch.randn(r, c, generator=g, device=dev).to(dtype)
    s = 1 + 0.1 * torch.randn(c, generator=g, device=dev)
    b = 0.1 * torch.randn(c, generator=g, device=dev)
    before = _build.launch_counts()
    y, mean, rstd = ln._fwd_kernel(x, s, b, 1e-12)
    dx = ln._bwd_dx_kernel(x, s, mean, rstd, dy)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    for name in ("layer_norm_fwd", "layer_norm_bwd_dx"):
        assert after[name] == before.get(name, 0) + 1
    if c == 1:      # one column: variance 0, rstd = rsqrt(eps) = 1e6
        torch.testing.assert_close(rstd, torch.full_like(rstd, 1e6),
                                   rtol=1e-5, atol=0)
        return
    y_r, mean_r, rstd_r = ln.layer_norm_reference(x, s, b, 1e-12)
    dx_r = ln.layer_norm_bwd_dx_reference(x, s, mean_r, rstd_r, dy)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(mean, mean_r, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, rstd_r, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(y.float(), y_r.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(dx.float(), dx_r.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("r,c", ROW_SHAPES[1:])
def test_dropout_add_ln_kernels_match_plain(dev, dtype, p, r, c):
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import fused_residual as fr
    g = _g(10)
    x, res, dy = (torch.randn(r, c, generator=g, device=dev).to(dtype)
                  for _ in range(3))
    s = 1 + 0.1 * torch.randn(c, generator=g, device=dev)
    b = 0.1 * torch.randn(c, generator=g, device=dev)
    seed = -1234567
    before = _build.launch_counts()
    y, z, mean, rstd = fr._fwd_kernel(x, res, s, b, seed, p, 1e-12)
    dx, dres = fr._bwd_kernel(z, s, mean, rstd, dy, seed, p)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    for name in ("dropout_add_ln_fwd", "dropout_add_ln_bwd"):
        assert after[name] == before.get(name, 0) + 1
    y_r, z_r, mean_r, rstd_r = fr.dropout_add_ln_reference(x, res, s, b,
                                                           seed, p, 1e-12)
    # the backward of both from the kernel's own z and statistics
    dx_r, dres_r = fr.dropout_add_ln_bwd_reference(z, s, mean, rstd, dy,
                                                   seed, p)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(mean, mean_r, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, rstd_r, atol=1e-4, rtol=1e-4)
    for a, w in ((y, y_r), (z, z_r), (dx, dx_r), (dres, dres_r)):
        torch.testing.assert_close(a.float(), w.float(), atol=tol, rtol=tol)
    if p > 0:       # the mask, bit for bit: dx is zero where it dropped
        keep = fr.keep_mask(seed, r, c, p, dev)
        assert torch.equal(dx != 0, keep & (dres != 0))


def test_row_kernels_autograd_and_determinism(dev):
    """The autograd Functions on the card: gradients equal those of the
    plain versions on CPU copies, and two runs give identical bits."""
    from paddle_tpu_torch.ops.fused_residual import fused_dropout_add_ln
    from paddle_tpu_torch.ops.layer_norm import fused_layer_norm
    g = _g(11)
    x, res, dy = (torch.randn(40, 768, generator=g, device=dev)
                  for _ in range(3))
    s = 1 + 0.1 * torch.randn(768, generator=g, device=dev)
    b = 0.1 * torch.randn(768, generator=g, device=dev)

    def run(device, fn):
        ts = [t.to(device).clone().requires_grad_() for t in (x, res, s, b)]
        y = fn(*ts)
        return [y.detach().cpu()] + [
            t.cpu() for t in torch.autograd.grad(y, ts, dy.to(device),
                                                 allow_unused=True)
            if t is not None]

    for fn in (lambda a, r, s_, b_: fused_dropout_add_ln(a, r, s_, b_, 77,
                                                         0.1, 1e-12),
               lambda a, r, s_, b_: fused_layer_norm(a + 0 * r, s_, b_,
                                                     1e-12)[0]):
        card, again, cpu = run(dev, fn), run(dev, fn), run("cpu", fn)
        for a, w in zip(card, again):
            assert torch.equal(a, w)
        for a, w in zip(card, cpu):
            torch.testing.assert_close(a, w, atol=2e-4, rtol=2e-4)


def test_row_kernels_counter_wraps_on_the_card(dev):
    """row * C + col passes 2**32 at C = 16384 beyond row 262144: the
    kernel's uint32 counter wraps as the plain version's masked int64."""
    from paddle_tpu_torch.ops import fused_residual as fr
    r, c, p, seed = 262144 + 8, 16384, 0.5, 3
    x = torch.ones(r, c, device=dev, dtype=torch.bfloat16)
    res = torch.zeros_like(x)
    s = torch.ones(c, device=dev)
    b = torch.zeros(c, device=dev)
    _, z, _, _ = fr._fwd_kernel(x, res, s, b, seed, p, 1e-5)
    rows = torch.arange(r - 8, r, device=dev)[:, None]
    cols = torch.arange(c, device=dev)[None, :]
    from paddle_tpu_torch.ops._launch import keep_threshold
    keep = fr.hash_u32(seed, rows * c + cols) >= keep_threshold(p)
    assert torch.equal(z[-8:] != 0, keep)
    del x, res, z


# -- the BERT variants of the sub-blocks and of flash ------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act,norm,p", [
    ("gelu", "post", 0.1), ("gelu", "post", 0.0), ("relu", "pre", 0.1),
    ("gelu_tanh", "pre", 0.0), ("relu", "none", 0.3), ("gelu", "none", 0.0)])
@pytest.mark.parametrize("m,h,i", [(1, 128, 512), (70, 200, 300),
                                   (2048, 768, 3072)])
def test_fused_ffn_ln_variants_match_plain(dev, dtype, act, norm, p, m, h, i):
    from paddle_tpu_torch.ops.fused_block import (ffn_ln_reference,
                                                  fused_ffn_ln)
    g = _g(12)

    def rn(*shape, sc=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * sc).to(dtype)

    args = (rn(m, h), rn(h, i, sc=0.05), rn(i, sc=0.1), rn(i, h, sc=0.05),
            rn(h, sc=0.1), rn(m, h),
            1 + 0.1 * torch.randn(h, generator=g, device=dev),
            0.1 * torch.randn(h, generator=g, device=dev))
    got = fused_ffn_ln(*args, act, norm, p, 1e-12, 99)
    want = ffn_ln_reference(*args, act, norm, p, 1e-12, 99)
    assert got.dtype == dtype
    tol = 2e-4 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(1, 256, 64), (37, 160, 200),
                                   (2048, 768, 768)])
def test_fused_out_ln_dropout_matches_plain(dev, dtype, m, k, n):
    from paddle_tpu_torch.ops.fused_block import (fused_out_ln,
                                                  out_ln_reference)
    from paddle_tpu_torch.ops.fused_residual import keep_mask
    g = _g(13)
    args = (torch.randn(m, k, generator=g, device=dev).to(dtype),
            (torch.randn(k, n, generator=g, device=dev) * 0.05).to(dtype),
            (torch.randn(n, generator=g, device=dev) * 0.1).to(dtype),
            torch.zeros(m, n, device=dev, dtype=dtype),
            1 + 0.1 * torch.randn(n, generator=g, device=dev),
            0.1 * torch.randn(n, generator=g, device=dev))
    z, h = fused_out_ln(*args, 0.1, 1e-12, 4321)
    zr, hr = out_ln_reference(*args, 0.1, 1e-12, 4321)
    tol = 2e-4 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(z.float(), zr.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(h.float(), hr.float(), atol=tol, rtol=tol)
    # zero residual: z is zero exactly where the mask dropped
    assert torch.equal(z != 0, keep_mask(4321, m, n, 0.1, dev))


def test_fused_block_variants_backward_on_the_card(dev):
    """Forward through the kernel with dropout and post-norm, backward
    the composed recompute with the mask replayed: gradients equal those
    of the plain chain under the same seed."""
    from paddle_tpu_torch.ops.fused_block import (ffn_ln_reference,
                                                  fused_ffn_ln)
    g = _g(14)
    args = [torch.randn(40, 256, generator=g, device=dev),
            torch.randn(256, 512, generator=g, device=dev) * 0.05,
            torch.zeros(512, device=dev),
            torch.randn(512, 256, generator=g, device=dev) * 0.05,
            torch.zeros(256, device=dev),
            torch.randn(40, 256, generator=g, device=dev),
            torch.ones(256, device=dev), torch.zeros(256, device=dev)]
    dy = torch.randn(40, 256, generator=g, device=dev)
    ts = [a.clone().requires_grad_() for a in args]
    got = torch.autograd.grad(fused_ffn_ln(*ts, "gelu", "post", 0.1, 1e-12,
                                           5), ts, dy)
    rs = [a.clone().requires_grad_() for a in args]
    want = torch.autograd.grad(ffn_ln_reference(*rs, "gelu", "post", 0.1,
                                                1e-12, 5), rs, dy)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("with_mask,p", [(True, 0.0), (False, 0.1),
                                         (True, 0.1)])
@pytest.mark.parametrize("b,h,s,t,d", [(2, 3, 128, 128, 64),
                                       (3, 2, 64, 192, 40),
                                       (1, 2, 128, 64, 256)])
def test_flash_mask_dropout_kernels_match_plain(dev, dtype, causal,
                                                with_mask, p, b, h, s, t, d):
    from paddle_tpu_torch.ops import flash_attention as fa
    g = _g(15)
    bh = b * h
    q = torch.randn(bh, s, d, generator=g, device=dev).to(dtype)
    k = torch.randn(bh, t, d, generator=g, device=dev).to(dtype)
    v = torch.randn(bh, t, d, generator=g, device=dev).to(dtype)
    do = torch.randn(bh, s, d, generator=g, device=dev).to(dtype)
    mask2 = None
    if with_mask:
        mask2 = torch.zeros(b, t, device=dev)
        for i in range(b):
            mask2[i, t - 5 - 7 * i:] = -1e9
    scale = d ** -0.5
    tail = (scale, causal, mask2, 2024, p)
    o, lse = fa._fwd_kernel(q, k, v, *tail)
    o_r, lse_r = fa.flash_fwd_reference(q, k, v, *tail)
    got = fa._bwd_kernels(q, k, v, o, lse, do, *tail)
    want = fa.flash_bwd_reference(q, k, v, o, lse, do, *tail)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(lse, lse_r, atol=1e-4, rtol=1e-4)
    for a, w in zip((o, *got), (o_r, *want)):
        torch.testing.assert_close(a.float(), w.float(), atol=tol, rtol=tol)


def test_flash_dropout_mask_is_bit_equal_on_the_card(dev):
    """Two identity-block V's turn the output into the dropped
    probabilities themselves: their zero pattern is keep_mask_salted."""
    from paddle_tpu_torch.ops import flash_attention as fa
    g = _g(16)
    bh, t, d, p, seed = 6, 128, 64, 0.1, -5
    q = torch.randn(bh, t, d, generator=g, device=dev) * 0.3
    k = torch.randn(bh, t, d, generator=g, device=dev) * 0.3
    keep = fa.keep_mask_salted(seed, bh, t, t, p, dev)
    for half in (0, 1):
        v = torch.zeros(bh, t, d, device=dev)
        v[:, half * d:(half + 1) * d] = torch.eye(d, device=dev)
        o, _ = fa._fwd_kernel(q, k, v, d ** -0.5, False, None, seed, p)
        assert torch.equal(o != 0, keep[:, :, half * d:(half + 1) * d])


# ---------------------------------------------------------------------------
# B row 10: fused_ffn (csrc/fused_ffn.cu)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ["gelu", "gelu_tanh", "relu"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,h,i", [(1, 128, 512), (37, 160, 200),
                                   (300, 768, 3072), (257, 1032, 640),
                                   (64, 2048, 512), (33, 4096, 256)])
def test_fused_ffn_kernel_matches_plain(dev, m, h, i, dt, act):
    """Ragged rows (odd M, M < the 16/32-row tile), widths that are not
    multiples of the 128-wide I chunk or the 256-wide output pass, 16-row
    blocks, H split into column tiles (few row blocks: 257 x 1032 takes
    five 207-column tiles, 33 x 4096 sixteen of 256); two runs give
    identical bits."""
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops.fused_ffn import ffn_reference, fused_ffn
    g = _g(10)
    args = (torch.randn(m, h, generator=g, device=dev).to(dt),
            (torch.randn(h, i, generator=g, device=dev) * 0.05).to(dt),
            (torch.randn(i, generator=g, device=dev) * 0.1).to(dt),
            (torch.randn(i, h, generator=g, device=dev) * 0.05).to(dt),
            (torch.randn(h, generator=g, device=dev) * 0.1).to(dt))
    before = _build.launch_counts().get("fused_ffn", 0)
    got = fused_ffn(*args, act)
    again = fused_ffn(*args, act)
    want = ffn_reference(*args, act)
    torch.cuda.synchronize()
    assert _build.launch_counts()["fused_ffn"] == before + 2
    assert torch.equal(got, again)
    tol = 1e-4 if dt == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("m,h,sms,want", [
    (8192, 768, 132, (32, 768)), (2048, 768, 132, (16, 768)),
    (1024, 2048, 132, (16, 1024)), (1024, 2048, 114, (16, 2048)),
    (8192, 4096, 132, (16, 2048)), (8192, 1032, 132, (16, 1032)),
    (300, 768, 132, (16, 256)), (8, 2048, 132, (16, 256))])
def test_fused_ffn_tiles(dev, m, h, sms, want):
    """The launcher's tiles: 32 rows only when every SM still gets a row
    block and all of H fits the 128 KB accumulator; H split into column
    tiles beyond the accumulator, and when the row blocks leave more than
    half the SMs idle (never below one 256-column pass)."""
    import ctypes
    from paddle_tpu_torch.ops import _build
    out = (ctypes.c_int * 2)()
    fn = _build.function("fused_ffn", "fused_ffn_tiles", 1, 3)
    assert fn(out, m, h, sms) == 0
    assert tuple(out) == want


def test_fused_ffn_kernel_gradients(dev):
    """The autograd Function on the card: kernel forward, composed f32
    backward, against the plain chain's autograd."""
    from paddle_tpu_torch.ops.fused_ffn import _chain_f32, fused_ffn
    g = _g(11)
    ts = [torch.randn(*s, generator=g, device=dev) * sc
          for s, sc in (((256, 128), 1.0), ((128, 512), 0.05), ((512,), 0.1),
                        ((512, 128), 0.05), ((128,), 0.1))]
    a = [t.clone().requires_grad_() for t in ts]
    b = [t.clone().requires_grad_() for t in ts]
    ga = torch.autograd.grad((fused_ffn(*a) ** 2).sum(), a)
    gb = torch.autograd.grad((_chain_f32(*b, "gelu") ** 2).sum(), b)
    for x, y in zip(ga, gb):
        torch.testing.assert_close(x, y, atol=2e-4, rtol=2e-4)


def test_static_ffn_program_on_the_card(dev):
    """The fused_ffn op in a static program on Executor(CUDAPlace(0)):
    two kernel launches a step (the op and its grad op's re-run)."""
    import numpy as np
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.common_ops import run_op
    from paddle_tpu_torch.fluid import (CUDAPlace, Executor, Scope,
                                        framework, layers, optimizer,
                                        scope_guard, unique_name)
    from paddle_tpu_torch.ops import _build
    pt.enable_static()
    try:
        with unique_name.guard():
            main, startup = framework.Program(), framework.Program()
            with framework.program_guard(main, startup):
                x = layers.data("x", [-1, 128], "float32")
                w1 = layers.create_parameter([128, 512], "float32")
                b1 = layers.create_parameter([512], "float32", is_bias=True)
                w2 = layers.create_parameter([512, 128], "float32")
                b2 = layers.create_parameter([128], "float32", is_bias=True)
                y = run_op("fused_ffn", {"X": x, "W1": w1, "B1": b1,
                                         "W2": w2, "B2": b2})
                loss = layers.mean(y * y)
                optimizer.Adam(learning_rate=1e-2).minimize(loss)
    finally:
        pt.disable_static()
    feed = {"x": np.random.RandomState(0).randn(256, 128).astype("float32")}
    with scope_guard(Scope()):
        exe = Executor(CUDAPlace(0))
        exe.run(startup)
        before = _build.launch_counts().get("fused_ffn", 0)
        losses = [float(exe.run(main, feed=feed, fetch_list=[loss])[0][0])
                  for _ in range(3)]
    assert _build.launch_counts()["fused_ffn"] == before + 6
    assert losses[-1] < losses[0]

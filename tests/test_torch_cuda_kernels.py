"""The port's CUDA kernels against their plain PyTorch versions on the
card, at edge shapes the serving and training paths can produce: ragged
row counts (M = 1, not a multiple of the 32-row tile), widths that are
not multiples of the column tiles, split-K and unsplit launches,
page-table rows padded with the trash page, float32 and bfloat16 caches
and sub-block inputs; the three flash kernels at every head-dim bucket
(D <= 64, <= 128, <= 256), causal or not, S != T, float32 and bfloat16.

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

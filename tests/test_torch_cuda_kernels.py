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
flash kernels; the sub-blocks' tensor-core route (bf16, widths that are
multiples of 64) at ragged M and the GPT-3 XL training shapes, every
variant, masks bit-equal, reruns bit-identical, and the route each call
takes (counted per route; a misaligned view takes the SIMT kernels); the
flash kernels' two routes in bf16 at the GPT-3 XL, BERT-base, T = 192
and D = 64 causal shapes, against plain versions that round P and dS
where the reference does (at most 1% of the elements another bf16
number), dropout masks bit-equal on the tensor cores, reruns
bit-identical, and the route by dtype, head dim and alignment; the
split-context paged-attention kernel at d 64 / 128, ps 16 / 32 / 128 and
ctx 0, 1, ps, ps + 1, inside a split and the whole table, against both
plain versions, reruns bit-identical; fused_ffn on its tensor-core and
FFMA routes (every activation, ragged M, reruns bit-identical), its bias
epilogue bit-equal to fused_ffn_ln's residual one with a zero residual
(the GEMM cores both files share), and the calls that stay on SIMT;
paged-attention decode at the shapes its first kernel did not take
(head_dim or page size past 128, K/V rows that are not whole 16-byte
pieces, q in bf16 or f16, misaligned or strided pools), served by the
scalar kernel (or the vector one at ps = 256), split or not; the
layer-norm kernels' two routes ("warp", "row"; misaligned copies take
the row route) around the warp route's cap of C = 1024, reruns
bit-identical, a zero-variance row, and the route each call takes; the
same for the dropout + residual + layer-norm pair, whose backward at
p = 0 writes one gradient (dres, returned as both).

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


# ctx 0, 1, one page, one page + 1, a slot that ends inside a split (with
# three pages a split: page 3 is the first of split 1), and the whole table
def _split_ctx(ps, M):
    return (0, 1, ps, ps + 1, 3 * ps + 3, M * ps)


@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ps", [16, 32, 128])
@pytest.mark.parametrize("d", [64, 128])
def test_paged_attention_split_kernel_matches_plain(dev, cache, d, ps):
    """The split-context kernel (S = 6, H = 16: paged_splits gives three
    pages a split of the 40-page table at 132 SMs) against the split
    plain version on every slot, ctx 0 included (0 out), within 2e-5 for
    both caches (it keeps P in f32, as the kernel does), and against the
    gather plain version on the slots with ctx > 0 (2e-5 in f32, 2e-2
    with a bf16 cache: it rounds P to bf16); one launch a call, the same
    bits when run again, and every ticket back at zero."""
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops._launch import _WORK
    from paddle_tpu_torch.ops.fused_block import _sms
    from paddle_tpu_torch.ops.paged_attention import (
        paged_attention_decode, paged_attention_reference,
        paged_attention_split_reference, paged_splits)
    S, H, M = 6, 16, 40
    P = S * M
    g = _g(3)
    q = torch.randn(S, H, d, generator=g, device=dev)
    k = torch.randn(P + 1, ps, H, d, generator=g, device=dev).to(cache)
    v = torch.randn(P + 1, ps, H, d, generator=g, device=dev).to(cache)
    ctx = torch.tensor(_split_ctx(ps, M), dtype=torch.int32, device=dev)
    pt = torch.randperm(P, generator=g, device=dev).reshape(S, M)
    pt = pt.to(torch.int32).contiguous()
    for s in range(S):
        pt[s, math.ceil(int(ctx[s]) / ps):] = P          # trash padding
    pps = paged_splits(S, H, M, _sms(dev.index or 0))
    assert math.ceil(M / pps) > 1
    before = _build.launch_counts().get("paged_attention", 0)
    got = paged_attention_decode(q, k, v, pt, ctx)
    again = paged_attention_decode(q, k, v, pt, ctx)
    torch.cuda.synchronize()
    assert _build.launch_counts()["paged_attention"] == before + 2
    assert torch.equal(got, again)
    assert not any(t.any() for key, t in _WORK.items()
                   if key[2] == "tickets")
    split = paged_attention_split_reference(q, k, v, pt, ctx,
                                            pages_per_split=pps)
    torch.testing.assert_close(got, split, atol=2e-5, rtol=2e-5)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    tol = 2e-5 if cache == torch.float32 else 2e-2
    gather = paged_attention_reference(q, k, v, pt, ctx)
    torch.testing.assert_close(got[1:], gather[1:], atol=tol, rtol=tol)


def test_paged_attention_one_split(dev):
    """2048 (slot, head) pairs fill a 132-SM card alone: one split,
    nothing to merge, the block normalises and writes out itself."""
    from paddle_tpu_torch.ops.fused_block import _sms
    from paddle_tpu_torch.ops.paged_attention import (
        paged_attention_decode, paged_attention_split_reference,
        paged_splits)
    S, H, d, ps, M = 64, 32, 64, 16, 8
    P = S * M
    g = _g(4)
    q = torch.randn(S, H, d, generator=g, device=dev)
    k = torch.randn(P + 1, ps, H, d, generator=g, device=dev)
    v = torch.randn(P + 1, ps, H, d, generator=g, device=dev)
    ctx = torch.randint(0, M * ps + 1, (S,), generator=g, device=dev,
                        dtype=torch.int32)
    pt = torch.randperm(P, generator=g, device=dev).reshape(S, M)
    pt = pt.to(torch.int32).contiguous()
    pps = paged_splits(S, H, M, _sms(dev.index or 0))
    if _sms(dev.index or 0) <= 170:
        assert pps == M
    got = paged_attention_decode(q, k, v, pt, ctx)
    want = paged_attention_split_reference(q, k, v, pt, ctx, pps)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    assert torch.equal(got, paged_attention_decode(q, k, v, pt, ctx))


# (name, q dtype, pool dtype, d, ps, pool layout, route): the shapes of
# fault C2 (the reference serves them, the first kernel raised on them);
# layout "offset" views each pool 4 bytes (f32) or 8 bytes (bf16) off a
# 16-byte boundary, "strided" takes heads 0..H-1 of pools of H + 1 heads
C2_CASES = [
    ("d256_ps16", torch.float32, torch.float32, 256, 16, "", "scalar"),
    ("d256_ps16_bf16", torch.float32, torch.bfloat16, 256, 16, "", "scalar"),
    ("d128_ps256", torch.float32, torch.float32, 128, 256, "", "vector"),
    ("d4_bf16", torch.float32, torch.bfloat16, 4, 16, "", "scalar"),
    ("d6_f32", torch.float32, torch.float32, 6, 16, "", "scalar"),
    ("q_bf16", torch.bfloat16, torch.bfloat16, 128, 16, "", "scalar"),
    ("q_f16", torch.float16, torch.float16, 64, 16, "", "scalar"),
    ("pools_4_bytes_off", torch.float32, torch.float32, 128, 16, "offset",
     "scalar"),
    ("pools_strided", torch.float32, torch.bfloat16, 128, 16, "strided",
     "scalar")]


def _paged_inputs(dev, seed, qdt, kvdt, d, ps, layout, S=3, H=2, M=4):
    g = _g(seed)
    P = S * M
    q = torch.randn(S, H, d, generator=g, device=dev).to(qdt)
    n = (P + 1) * ps * H * d
    if layout == "strided":
        k, v = (torch.randn(P + 1, ps, H + 1, d, generator=g,
                            device=dev).to(kvdt)[:, :, :H] for _ in range(2))
    else:
        off = 1 if layout == "offset" else 0
        k, v = (torch.randn(n + off, generator=g, device=dev).to(kvdt)
                [off:].view(P + 1, ps, H, d) for _ in range(2))
    ctx = torch.tensor([0, 1, ps + 1, M * ps][-S:], dtype=torch.int32,
                       device=dev)
    pt = torch.randperm(P, generator=g, device=dev).reshape(S, M)
    pt = pt.to(torch.int32).contiguous()
    for s in range(S):
        pt[s, math.ceil(int(ctx[s]) / ps):] = P
    return q, k, v, pt, ctx


@pytest.mark.parametrize("S", [3, 4])
@pytest.mark.parametrize("qdt,kvdt,d,ps,layout,route",
                         [c[1:] for c in C2_CASES],
                         ids=[c[0] for c in C2_CASES])
def test_paged_attention_serves_the_shapes_of_fault_c2(
        dev, qdt, kvdt, d, ps, layout, route, S):
    """On the card, decode at d = 256, ps = 256, bf16 d = 4, f32 d = 6,
    q bf16 or f16, pools off a 16-byte boundary and strided pools takes a
    kernel (the route paged_route gives: the scalar kernel but at
    ps = 256) instead of raising: one launch counted under
    paged_attention and its route, split over the context (the grid of
    3 or 4 slots of 2 heads splits the 4-page table a page a split), the
    same bits when run again, every ticket back at zero; against the
    split plain version (P in f32, as the kernels keep it) on every
    slot within 2e-5 (f32 q) or 2e-2 (a bf16 or f16 q: the output is
    rounded to it), against the gather one on the slots with ctx > 0
    within 2e-5 (f32 q and pools) or 2e-2; ctx 0 gives 0."""
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops._launch import _WORK
    from paddle_tpu_torch.ops.fused_block import _sms
    from paddle_tpu_torch.ops.paged_attention import (
        paged_attention_decode, paged_attention_reference,
        paged_attention_split_reference, paged_route, paged_splits)
    q, k, v, pt, ctx = _paged_inputs(dev, 21, qdt, kvdt, d, ps, layout, S=S)
    assert paged_route(qdt, kvdt, d, (k.data_ptr(), v.data_ptr()),
                       k.is_contiguous()) == route
    before = _build.launch_counts()
    got = paged_attention_decode(q, k, v, pt, ctx)
    again = paged_attention_decode(q, k, v, pt, ctx)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    for name in ("paged_attention", f"paged_attention.{route}"):
        assert after.get(name, 0) == before.get(name, 0) + 2
    assert torch.equal(got, again)
    assert got.dtype == qdt and got.shape == q.shape
    assert not any(t.any() for key, t in _WORK.items()
                   if key[2] == "tickets")
    pps = paged_splits(S, 2, 4, _sms(dev.index or 0))
    split = paged_attention_split_reference(q, k, v, pt, ctx, pps)
    tol = 2e-5 if qdt == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), split.float(), atol=tol,
                               rtol=tol)
    live = ctx > 0
    assert torch.equal(got[~live], torch.zeros_like(got[~live]))
    gather = paged_attention_reference(q, k, v, pt, ctx)
    tol = 2e-5 if qdt == kvdt == torch.float32 else 2e-2
    torch.testing.assert_close(got[live].float(), gather[live].float(),
                               atol=tol, rtol=tol)


def test_paged_attention_scalar_one_split(dev):
    """The scalar kernel with one split (2048 (slot, head) pairs): the
    block normalises and writes out itself; d = 256 in f32."""
    from paddle_tpu_torch.ops.fused_block import _sms
    from paddle_tpu_torch.ops.paged_attention import (
        paged_attention_decode, paged_attention_split_reference,
        paged_splits)
    S, H, d, ps, M = 64, 32, 256, 16, 4
    P = S * M
    g = _g(24)
    q = torch.randn(S, H, d, generator=g, device=dev)
    k = torch.randn(P + 1, ps, H, d, generator=g, device=dev)
    v = torch.randn(P + 1, ps, H, d, generator=g, device=dev)
    ctx = torch.randint(0, M * ps + 1, (S,), generator=g, device=dev,
                        dtype=torch.int32)
    pt = torch.randperm(P, generator=g, device=dev).reshape(S, M)
    pt = pt.to(torch.int32).contiguous()
    pps = paged_splits(S, H, M, _sms(dev.index or 0))
    if _sms(dev.index or 0) <= 170:
        assert pps == M
    got = paged_attention_decode(q, k, v, pt, ctx)
    want = paged_attention_split_reference(q, k, v, pt, ctx, pps)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    assert torch.equal(got, paged_attention_decode(q, k, v, pt, ctx))


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


# -- the tensor-core route of the sub-blocks (bf16, widths % 64 == 0) ------

def _counted(name, fn):
    """fn()'s result and the per-route launches of `name` it made (the
    sub-blocks have a fourth route, stream)."""
    from paddle_tpu_torch.ops import _build
    routes = ("tc", "simt", "ffma") + (
        ("stream",) if name in ("fused_out_ln", "fused_ffn_ln") else ())
    before = _build.launch_counts()
    out = fn()
    after = _build.launch_counts()
    return out, {r: after.get(f"{name}.{r}", 0) - before.get(f"{name}.{r}", 0)
                 for r in routes}


def _bf16_block_args(dev, seed, m, h, i, zero_res=False):
    g = _g(seed)

    def rn(*shape, sc=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * sc
                ).to(torch.bfloat16)

    res = torch.zeros(m, h, device=dev, dtype=torch.bfloat16) if zero_res \
        else rn(m, h)
    return (rn(m, h), rn(h, i, sc=0.05), rn(i, sc=0.1), rn(i, h, sc=0.05),
            rn(h, sc=0.1), res,
            1 + 0.1 * torch.randn(h, generator=g, device=dev),
            0.1 * torch.randn(h, generator=g, device=dev))


TC_FFN_SHAPES = [(1, 128, 512), (37, 192, 320), (1000, 256, 1024),
                 (1024, 2048, 8192)]
TC_VARIANTS = [("gelu_tanh", "none", 0.0), ("gelu", "post", 0.1),
               ("gelu", "post", 0.0), ("relu", "pre", 0.1),
               ("gelu_tanh", "pre", 0.0), ("relu", "none", 0.3),
               ("gelu", "none", 0.1)]


@pytest.mark.parametrize("act,norm,p", TC_VARIANTS)
@pytest.mark.parametrize("m,h,i", TC_FFN_SHAPES)
def test_fused_ffn_ln_tensor_core_route_matches_plain(dev, m, h, i, act,
                                                      norm, p):
    """Every act / norm / p in bf16 on the tensor-core route, ragged M
    (TMA zero-fills the rows past M), widths that are multiples of 64
    but not of the 128-column tile: one launch of the route, within a
    bf16 step of the plain version (both round hid to bf16), and the
    same bits when run again."""
    from paddle_tpu_torch.ops.fused_block import (ffn_ln_reference,
                                                  fused_ffn_ln)
    args = _bf16_block_args(dev, 20, m, h, i)
    call = (*args, act, norm, p, 1e-5, 31)
    got, routes = _counted("fused_ffn_ln", lambda: fused_ffn_ln(*call))
    assert routes == {"tc": 1, "simt": 0, "ffma": 0, "stream": 0}
    want = ffn_ln_reference(*call)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2,
                               rtol=3e-2)
    assert torch.equal(got, fused_ffn_ln(*call))


@pytest.mark.parametrize("p", [0.1, 0.3])
@pytest.mark.parametrize("m,h,i", TC_FFN_SHAPES)
def test_tensor_core_dropout_masks_are_bit_equal(dev, m, h, i, p):
    """A zero residual leaves the output zero exactly where keep_mask
    dropped, in fused_ffn_ln (norm "none") and in fused_out_ln's z: the
    accumulator fragment maps back to the element's global (row, col)."""
    from paddle_tpu_torch.ops.fused_block import fused_ffn_ln, fused_out_ln
    from paddle_tpu_torch.ops.fused_residual import keep_mask
    args = _bf16_block_args(dev, 21, m, h, i, zero_res=True)
    out, routes = _counted("fused_ffn_ln", lambda: fused_ffn_ln(
        *args, "gelu", "none", p, 1e-5, 4321))
    assert routes["tc"] == 1
    keep = keep_mask(4321, m, h, p, dev)
    assert torch.equal(out != 0, keep)
    (z, _), routes = _counted("fused_out_ln", lambda: fused_out_ln(
        args[0], args[3][:h, :h].contiguous(), args[4], args[5], args[6],
        args[7], p, 1e-5, 4321))
    assert routes["tc"] == 1
    assert torch.equal(z != 0, keep)


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("m,k,n", [(1, 128, 64), (37, 192, 320),
                                   (1000, 512, 256), (1024, 2048, 2048)])
def test_fused_out_ln_tensor_core_route_matches_plain(dev, m, k, n, p):
    from paddle_tpu_torch.ops.fused_block import (fused_out_ln,
                                                  out_ln_reference)
    g = _g(22)
    bf = torch.bfloat16
    args = (torch.randn(m, k, generator=g, device=dev).to(bf),
            (torch.randn(k, n, generator=g, device=dev) * 0.05).to(bf),
            (torch.randn(n, generator=g, device=dev) * 0.1).to(bf),
            torch.randn(m, n, generator=g, device=dev).to(bf),
            1 + 0.1 * torch.randn(n, generator=g, device=dev),
            0.1 * torch.randn(n, generator=g, device=dev), p, 1e-5, 5)
    (z, h), routes = _counted("fused_out_ln", lambda: fused_out_ln(*args))
    assert routes == {"tc": 1, "simt": 0, "ffma": 0, "stream": 0}
    zr, hr = out_ln_reference(*args)
    torch.testing.assert_close(z.float(), zr.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(h.float(), hr.float(), atol=2e-2, rtol=2e-2)
    z2, h2 = fused_out_ln(*args)
    assert torch.equal(z, z2) and torch.equal(h, h2)


def test_sub_block_routes_by_dtype_width_and_alignment(dev):
    """bf16 at widths % 64 == 0 takes the tensor cores; f32 at 64 rows
    and such widths the stream kernels (while 64 <= _STREAM_MAX_ROWS,
    else SIMT); ragged widths and a misaligned view take the SIMT
    kernels, whose results still match the plain version: a view TMA
    cannot read is never launched on the tensor-core route."""
    from paddle_tpu_torch.ops.fused_block import (_STREAM_MAX_ROWS,
                                                  ffn_ln_reference,
                                                  fused_ffn_ln, fused_out_ln,
                                                  out_ln_reference)
    bf = torch.bfloat16
    args = _bf16_block_args(dev, 23, 64, 128, 256)
    _, routes = _counted("fused_ffn_ln", lambda: fused_ffn_ln(*args[:6]))
    assert routes == {"tc": 1, "simt": 0, "ffma": 0, "stream": 0}
    f32 = [a.float() for a in args]
    _, routes = _counted("fused_ffn_ln", lambda: fused_ffn_ln(*f32[:6]))
    on_stream = int(64 <= _STREAM_MAX_ROWS)
    assert routes == {"tc": 0, "simt": 1 - on_stream, "ffma": 0,
                      "stream": on_stream}
    ragged = _bf16_block_args(dev, 24, 64, 160, 200)
    _, routes = _counted("fused_ffn_ln", lambda: fused_ffn_ln(*ragged[:6]))
    assert routes == {"tc": 0, "simt": 1, "ffma": 0, "stream": 0}
    # rows 1.. of a (65, 128) buffer: contiguous, 256 bytes past a row
    # start, but the view of a flat buffer from element 4 is 8 bytes off
    flat = torch.randn(64 * 128 + 4, device=dev).to(bf)
    x = flat[4:].view(64, 128)
    assert x.is_contiguous() and x.data_ptr() % 16 == 8
    call = (x, *args[1:6])
    got, routes = _counted("fused_ffn_ln", lambda: fused_ffn_ln(*call))
    assert routes == {"tc": 0, "simt": 1, "ffma": 0, "stream": 0}
    torch.testing.assert_close(got.float(), ffn_ln_reference(*call).float(),
                               atol=3e-2, rtol=3e-2)
    w = (torch.randn(128, 128, device=dev) * 0.05).to(bf)
    ocall = (x, w, args[4], args[5], args[6], args[7])
    (z, h), routes = _counted("fused_out_ln", lambda: fused_out_ln(*ocall))
    assert routes == {"tc": 0, "simt": 1, "ffma": 0, "stream": 0}
    zr, hr = out_ln_reference(*ocall)
    torch.testing.assert_close(z.float(), zr.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(h.float(), hr.float(), atol=2e-2, rtol=2e-2)


# -- the FFMA route of the sub-blocks (f32, M >= 128, widths % 64 == 0) ----

def _f32_block_args(dev, seed, m, h, i):
    g = _g(seed)

    def rn(*shape, sc=1.0):
        return torch.randn(*shape, generator=g, device=dev) * sc

    return (rn(m, h), rn(h, i, sc=0.02), rn(i, sc=0.02), rn(i, h, sc=0.02),
            rn(h, sc=0.02), rn(m, h), 1 + rn(h, sc=0.1), rn(h, sc=0.1))


def _misaligned_f32(x):
    """The same numbers in a contiguous view 8 bytes off a 16-byte
    boundary, which the FFMA route does not take."""
    flat = torch.empty(x.numel() + 2, device=x.device, dtype=x.dtype)
    y = flat[2:].view(x.shape)
    y.copy_(x)
    assert y.is_contiguous() and y.data_ptr() % 16 == 8
    return y


def _ffma_tol(m, n, p):
    """f32 sums of up to 8192 terms in another order than cuBLAS's:
    1e-4 + 1e-4 |ref|, 2e-4 at BERT's shape with dropout (the division
    by 1 - p, as chip_smoke.py's BERT rows)."""
    return 2e-4 if (m, n) == (2048, 768) and p > 0 else 1e-4


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("k,n", [(2048, 2048), (768, 768)])
@pytest.mark.parametrize("m", [128, 200, 256, 2048])
def test_fused_out_ln_ffma_route_matches_plain(dev, m, k, n, p):
    """f32 at the prefill buckets (128, 256), ragged M (200) and BERT's
    2048 rows, GPT-3 XL and BERT-base widths: one launch of the FFMA
    route within tolerance of the plain version, the same bits when run
    again, z zero exactly where keep_mask drops (zero residual), and the
    same numbers 8 bytes off alignment on the SIMT route, still within
    tolerance."""
    from paddle_tpu_torch.ops.fused_block import (fused_out_ln,
                                                  out_ln_reference)
    from paddle_tpu_torch.ops.fused_residual import keep_mask
    g = _g(40)

    def rn(*shape, sc=1.0):
        return torch.randn(*shape, generator=g, device=dev) * sc

    a, w, b, res = rn(m, k), rn(k, n, sc=0.02), rn(n, sc=0.02), rn(m, n)
    args = (a, w, b, res, 1 + rn(n, sc=0.1), rn(n, sc=0.1), p, 1e-5, 9)
    tol = _ffma_tol(m, n, p)
    (z, h), routes = _counted("fused_out_ln", lambda: fused_out_ln(*args))
    assert routes == {"tc": 0, "simt": 0, "ffma": 1, "stream": 0}
    zr, hr = out_ln_reference(*args)
    torch.testing.assert_close(z, zr, atol=tol, rtol=tol)
    torch.testing.assert_close(h, hr, atol=tol, rtol=tol)
    z2, h2 = fused_out_ln(*args)
    assert torch.equal(z, z2) and torch.equal(h, h2)
    (z0, _), routes = _counted("fused_out_ln", lambda: fused_out_ln(
        a, w, b, torch.zeros_like(res), *args[4:6], 0.1, 1e-5, 9))
    assert routes["ffma"] == 1
    assert torch.equal(z0 != 0, keep_mask(9, m, n, 0.1, dev))
    off = (_misaligned_f32(a), *args[1:])
    (zs, hs), routes = _counted("fused_out_ln", lambda: fused_out_ln(*off))
    assert routes == {"tc": 0, "simt": 1, "ffma": 0, "stream": 0}
    torch.testing.assert_close(zs, zr, atol=tol, rtol=tol)
    torch.testing.assert_close(hs, hr, atol=tol, rtol=tol)


FFMA_FFN_CASES = [  # m, h, i, act, norm, p
    (2048, 768, 3072, "gelu", "post", 0.1),      # BERT-base
    (256, 2048, 8192, "gelu_tanh", "none", 0.0),  # GPT-3 XL prefill
    (200, 768, 3072, "relu", "pre", 0.1),         # ragged M, pre-norm
]


@pytest.mark.parametrize("m,h,i,act,norm,p", FFMA_FFN_CASES)
def test_fused_ffn_ln_ffma_route_matches_plain(dev, m, h, i, act, norm, p):
    """fused_ffn_ln in f32 on the FFMA route (LN, up product with the
    activation, down product with dropout + residual, LN): within
    tolerance of the plain version, the same bits when run again, the
    output zero exactly where keep_mask drops (zero residual, norm
    "none", p = 0.1), and a misaligned x on the SIMT route, still within
    tolerance."""
    from paddle_tpu_torch.ops.fused_block import (ffn_ln_reference,
                                                  fused_ffn_ln)
    from paddle_tpu_torch.ops.fused_residual import keep_mask
    args = _f32_block_args(dev, 42, m, h, i)
    call = (*args, act, norm, p, 1e-5, 13)
    tol = _ffma_tol(m, h, p)
    got, routes = _counted("fused_ffn_ln", lambda: fused_ffn_ln(*call))
    assert routes == {"tc": 0, "simt": 0, "ffma": 1, "stream": 0}
    want = ffn_ln_reference(*call)
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)
    assert torch.equal(got, fused_ffn_ln(*call))
    zero = (*args[:5], torch.zeros_like(args[5]), *args[6:])
    out, routes = _counted("fused_ffn_ln", lambda: fused_ffn_ln(
        *zero, act, "none", 0.1, 1e-5, 13))
    assert routes["ffma"] == 1
    assert torch.equal(out != 0, keep_mask(13, m, h, 0.1, dev))
    off = (_misaligned_f32(args[0]), *call[1:])
    got_s, routes = _counted("fused_ffn_ln", lambda: fused_ffn_ln(*off))
    assert routes == {"tc": 0, "simt": 1, "ffma": 0, "stream": 0}
    torch.testing.assert_close(got_s, want, atol=tol, rtol=tol)


# -- the stream route of the sub-blocks (f32, 1 .. _STREAM_MAX_ROWS rows) --

def _stream_rows():
    from paddle_tpu_torch.ops.fused_block import _STREAM_MAX_ROWS
    return sorted({1, 3, 8, 16, _STREAM_MAX_ROWS})


# (K, N) of fused_out_ln and (H, I) of fused_ffn_ln: GPT-3 XL's out
# projection, BERT-base's FFN, GPT-3 XL's FFN
STREAM_WIDTHS = [(2048, 2048), (768, 3072), (2048, 8192)]
STREAM_TOL = 1e-4   # f32 sums of up to 8192 terms in another order


def _tickets_at_zero():
    from paddle_tpu_torch.ops._launch import _WORK
    return not any(t.any() for key, t in _WORK.items() if key[2] == "tickets")


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("k,n", STREAM_WIDTHS)
@pytest.mark.parametrize("m", _stream_rows())
def test_fused_out_ln_stream_route_matches_plain(dev, m, k, n, p):
    """f32 at decode's row counts: one launch of the stream route within
    1e-4 + 1e-4 |ref| of the plain version, the same bits when run
    again, every ticket back at zero, and with a zero residual z zero
    exactly where keep_mask drops."""
    from paddle_tpu_torch.ops.fused_block import (fused_out_ln,
                                                  out_ln_reference)
    from paddle_tpu_torch.ops.fused_residual import keep_mask
    g = _g(60)

    def rn(*shape, sc=1.0):
        return torch.randn(*shape, generator=g, device=dev) * sc

    a, w, b, res = rn(m, k), rn(k, n, sc=0.02), rn(n, sc=0.02), rn(m, n)
    args = (a, w, b, res, 1 + rn(n, sc=0.1), rn(n, sc=0.1), p, 1e-5, 11)
    (z, h), routes = _counted("fused_out_ln", lambda: fused_out_ln(*args))
    assert routes == {"tc": 0, "simt": 0, "ffma": 0, "stream": 1}
    zr, hr = out_ln_reference(*args)
    torch.testing.assert_close(z, zr, atol=STREAM_TOL, rtol=STREAM_TOL)
    torch.testing.assert_close(h, hr, atol=STREAM_TOL, rtol=STREAM_TOL)
    z2, h2 = fused_out_ln(*args)
    assert torch.equal(z, z2) and torch.equal(h, h2)
    if p > 0:
        z0, _ = fused_out_ln(a, w, b, torch.zeros_like(res), *args[4:])
        assert torch.equal(z0 != 0, keep_mask(11, m, n, p, dev))
    torch.cuda.synchronize()
    assert _tickets_at_zero()


@pytest.mark.parametrize("h,i", STREAM_WIDTHS)
@pytest.mark.parametrize("m", _stream_rows())
def test_fused_ffn_ln_stream_route_matches_plain(dev, m, h, i):
    """fused_ffn_ln in f32 at decode's row counts (gelu_tanh, no norm,
    no dropout: the serving path's call): one call on the stream route
    (two launches), within 1e-4 + 1e-4 |ref| of the plain version, the
    same bits when run again, every ticket back at zero."""
    from paddle_tpu_torch.ops.fused_block import (ffn_ln_reference,
                                                  fused_ffn_ln)
    args = _f32_block_args(dev, 61, m, h, i)[:6]
    got, routes = _counted("fused_ffn_ln", lambda: fused_ffn_ln(*args))
    assert routes == {"tc": 0, "simt": 0, "ffma": 0, "stream": 1}
    want = ffn_ln_reference(*args)
    torch.testing.assert_close(got, want, atol=STREAM_TOL, rtol=STREAM_TOL)
    assert torch.equal(got, fused_ffn_ln(*args))
    torch.cuda.synchronize()
    assert _tickets_at_zero()


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("norm", ["none", "pre", "post"])
@pytest.mark.parametrize("act", ["gelu_tanh", "gelu", "relu"])
@pytest.mark.parametrize("m", [3, 8])
def test_fused_ffn_ln_stream_variants_match_plain(dev, m, act, norm, p):
    """Every act / norm / p on the stream route at BERT-base width:
    within 1e-4 + 1e-4 |ref| of the plain version, the same bits when
    run again; with norm "none" and a zero residual the output is zero
    exactly where keep_mask drops."""
    from paddle_tpu_torch.ops.fused_block import (ffn_ln_reference,
                                                  fused_ffn_ln)
    from paddle_tpu_torch.ops.fused_residual import keep_mask
    h, i = 768, 3072
    args = _f32_block_args(dev, 62, m, h, i)
    call = (*args, act, norm, p, 1e-5, 17)
    got, routes = _counted("fused_ffn_ln", lambda: fused_ffn_ln(*call))
    assert routes == {"tc": 0, "simt": 0, "ffma": 0, "stream": 1}
    want = ffn_ln_reference(*call)
    torch.testing.assert_close(got, want, atol=STREAM_TOL, rtol=STREAM_TOL)
    assert torch.equal(got, fused_ffn_ln(*call))
    if norm == "none" and p > 0:
        zero = (*args[:5], torch.zeros_like(args[5]), *args[6:])
        out = fused_ffn_ln(*zero, act, norm, p, 1e-5, 17)
        assert torch.equal(out != 0, keep_mask(17, m, h, p, dev))


def test_stream_route_streams_do_not_share_tickets(dev):
    """Calls on two streams at once take their tickets, partials and hid
    from two workspaces: both give the default stream's bits, and every
    ticket of each is back at zero."""
    from paddle_tpu_torch.ops._launch import _WORK
    from paddle_tpu_torch.ops.fused_block import fused_ffn_ln, fused_out_ln
    a, w1, b1, w2, b2, res, ls, lb = _f32_block_args(dev, 63, 8, 2048, 8192)
    w = w2[:2048].contiguous()
    want = (fused_out_ln(a, w, b2, res, ls, lb),
            fused_ffn_ln(a, w1, b1, w2, b2, res, ls, lb, norm="post"))
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    got = {}
    for _ in range(3):
        for st in streams:
            with torch.cuda.stream(st):
                got[st] = (fused_out_ln(a, w, b2, res, ls, lb),
                           fused_ffn_ln(a, w1, b1, w2, b2, res, ls, lb,
                                        norm="post"))
    torch.cuda.synchronize()
    for st in streams:
        (z, h), out = got[st]
        assert torch.equal(z, want[0][0]) and torch.equal(h, want[0][1])
        assert torch.equal(out, want[1])
    ids = [st.cuda_stream for st in streams]
    tickets = [_WORK[(dev.index or 0, s, "tickets")] for s in ids]
    assert tickets[0].data_ptr() != tickets[1].data_ptr()
    assert _WORK[(dev.index or 0, ids[0], "hid")].data_ptr() \
        != _WORK[(dev.index or 0, ids[1], "hid")].data_ptr()
    assert _tickets_at_zero()


def test_sub_block_simt_route_at_decode_through_a_misaligned_view(dev):
    """M = 8 at GPT-3 XL width with a or x 8 bytes off a 16-byte boundary
    takes the SIMT kernels, still within 1e-4 + 1e-4 |ref| of the plain
    version: they stay for the calls the stream route does not take."""
    from paddle_tpu_torch.ops.fused_block import (ffn_ln_reference,
                                                  fused_ffn_ln, fused_out_ln,
                                                  out_ln_reference)
    x, w1, b1, w2, b2, res, ls, lb = _f32_block_args(dev, 64, 8, 2048, 8192)
    w = w2[:2048].contiguous()
    off = _misaligned_f32(x)
    (z, h), routes = _counted("fused_out_ln", lambda: fused_out_ln(
        off, w, b2, res, ls, lb))
    assert routes == {"tc": 0, "simt": 1, "ffma": 0, "stream": 0}
    zr, hr = out_ln_reference(x, w, b2, res, ls, lb)
    torch.testing.assert_close(z, zr, atol=STREAM_TOL, rtol=STREAM_TOL)
    torch.testing.assert_close(h, hr, atol=STREAM_TOL, rtol=STREAM_TOL)
    got, routes = _counted("fused_ffn_ln", lambda: fused_ffn_ln(
        off, w1, b1, w2, b2, res))
    assert routes == {"tc": 0, "simt": 1, "ffma": 0, "stream": 0}
    torch.testing.assert_close(got, ffn_ln_reference(x, w1, b1, w2, b2, res),
                               atol=STREAM_TOL, rtol=STREAM_TOL)


def test_sub_block_routes_by_rows(dev):
    """f32 at widths % 64 == 0 and aligned: 1 .. _STREAM_MAX_ROWS rows on
    stream, then SIMT below 128 rows, FFMA from 128; bf16 at 8 rows on
    the tensor cores."""
    from paddle_tpu_torch.ops.fused_block import (_STREAM_MAX_ROWS,
                                                  fused_ffn_ln)
    cases = [(1, "stream"), (_STREAM_MAX_ROWS, "stream"), (128, "ffma")]
    if _STREAM_MAX_ROWS < 127:
        cases.append((_STREAM_MAX_ROWS + 1, "simt"))
    for m, route in cases:
        args = _f32_block_args(dev, 65, m, 128, 256)[:6]
        _, routes = _counted("fused_ffn_ln", lambda: fused_ffn_ln(*args))
        assert routes == {r: int(r == route) for r in routes}, m
    bf = [t.to(torch.bfloat16) for t in _f32_block_args(dev, 65, 8, 128,
                                                        256)[:6]]
    _, routes = _counted("fused_ffn_ln", lambda: fused_ffn_ln(*bf))
    assert routes == {"tc": 1, "simt": 0, "ffma": 0, "stream": 0}


# -- layer norm, dropout + residual + layer norm (forward and backward) ----

ROW_SHAPES = [(1, 1), (3, 7), (33, 100), (304, 768), (2048, 768),
              (5, 1030), (2, 16384), (7, 16383)]


# the layer-norm kernels' shapes: ROW_SHAPES and, around the warp route's
# register cap (C <= 1024), the cap and the cap plus one 16-byte vector
# in float32 (4 columns) and bfloat16 (8)
LN_ROW_SHAPES = ROW_SHAPES + [(64, 1024), (64, 1028), (64, 1032),
                              (131, 512), (8192, 768)]


def _ln_inputs(dev, seed, r, c, dtype):
    g = _g(seed)
    x = (torch.randn(r, c, generator=g, device=dev) * 2 + 0.5).to(dtype)
    dy = torch.randn(r, c, generator=g, device=dev).to(dtype)
    s = 1 + 0.1 * torch.randn(c, generator=g, device=dev)
    b = 0.1 * torch.randn(c, generator=g, device=dev)
    return x, dy, s, b


def _ln_misaligned(t):
    """A copy of `t` one element past a 16-byte boundary: ln_route sends
    it to the row route."""
    return torch.empty(t.numel() + 1, device=t.device,
                       dtype=t.dtype)[1:].view(t.shape).copy_(t)


@pytest.mark.parametrize("view", ["chosen", "misaligned"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,c", LN_ROW_SHAPES)
def test_layer_norm_kernels_match_plain(dev, dtype, r, c, view):
    """Both routes against the plain versions: f32 1e-4, bf16 2e-2,
    statistics 1e-5; the route ln_route picks ("chosen") and, on
    misaligned copies of x and dy, the row route. Each launch counts
    under its kernel and its route."""
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import layer_norm as ln
    x, dy, s, b = _ln_inputs(dev, 9, r, c, dtype)
    if view == "misaligned":
        x, dy = _ln_misaligned(x), _ln_misaligned(dy)
    took = ln.ln_route(c, dtype, [x.data_ptr(), s.data_ptr(), b.data_ptr()])
    assert view == "chosen" or took == "row"
    before = _build.launch_counts()
    y, mean, rstd = ln._fwd_kernel(x, s, b, 1e-12)
    dx = ln._bwd_dx_kernel(x, s, mean, rstd, dy)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    for name in ("layer_norm_fwd", "layer_norm_bwd_dx",
                 f"layer_norm_fwd.{took}", f"layer_norm_bwd_dx.{took}"):
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


def _both_routes(x, dy):
    """(route, x, dy) for the warp route (the aligned inputs) and the row
    route (misaligned copies)."""
    return [("warp", x, dy), ("row", _ln_misaligned(x), _ln_misaligned(dy))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,c", [(304, 768), (2048, 768), (5, 1024)])
def test_layer_norm_routes_are_bit_equal_run_to_run(dev, dtype, r, c):
    """Each route gives the same bits twice (sums in a fixed order)."""
    from paddle_tpu_torch.ops import layer_norm as ln
    x, dy, s, b = _ln_inputs(dev, 12, r, c, dtype)
    for route, xr, dyr in _both_routes(x, dy):
        assert ln.ln_route(c, dtype, [xr.data_ptr()]) == route
        runs = []
        for _ in range(2):
            y, mean, rstd = ln._fwd_kernel(xr, s, b, 1e-12)
            runs.append((y, mean, rstd,
                         ln._bwd_dx_kernel(xr, s, mean, rstd, dyr)))
        for a, w in zip(*runs):
            assert torch.equal(a, w), route


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_zero_variance_row_on_both_routes(dev, dtype):
    """A row of equal values: variance exactly 0 (two-pass statistics),
    rstd = rsqrt(1e-12) = 1e6, y = bias, a finite dx; on both routes."""
    from paddle_tpu_torch.ops import layer_norm as ln
    x, dy, s, b = _ln_inputs(dev, 13, 4, 768, dtype)
    x[0] = 3.25
    for route, xr, dyr in _both_routes(x, dy):
        assert ln.ln_route(768, dtype, [xr.data_ptr()]) == route
        y, mean, rstd = ln._fwd_kernel(xr, s, b, 1e-12)
        dx = ln._bwd_dx_kernel(xr, s, mean, rstd, dyr)
        torch.cuda.synchronize()
        assert float(mean[0]) == 3.25
        torch.testing.assert_close(rstd[0], torch.tensor(1e6, device=dev),
                                   rtol=1e-5, atol=0)
        assert torch.equal(y[0], b.to(dtype)), route
        assert bool(torch.isfinite(dx.float()).all()), route


def test_layer_norm_routes_by_width_dtype_and_alignment(dev):
    """The route each call takes, read from the counters: BERT's C = 768
    in f32 and bf16 on "warp", a misaligned view, C = 7 and C = 1028 on
    "row"; the autograd Function takes the same routes."""
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import layer_norm as ln

    def routes(fn):
        before = _build.launch_counts()
        fn()
        after = _build.launch_counts()
        return {k: after[k] - before.get(k, 0) for k in after
                if k.startswith("layer_norm") and after[k] != before.get(k, 0)}

    for dtype in (torch.float32, torch.bfloat16):
        x, dy, s, b = _ln_inputs(dev, 14, 16, 768, dtype)
        assert routes(lambda: ln._fwd_kernel(x, s, b, 1e-12)) == {
            "layer_norm_fwd": 1, "layer_norm_fwd.warp": 1}
        off = torch.empty(16 * 768 + 1, device=dev, dtype=dtype)[1:]
        xm = off.view(16, 768).copy_(x)
        assert routes(lambda: ln._fwd_kernel(xm, s, b, 1e-12)) == {
            "layer_norm_fwd": 1, "layer_norm_fwd.row": 1}
        xt = x.clone().requires_grad_()
        got = routes(lambda: ln.fused_layer_norm(xt, s, b, 1e-12)[0]
                     .backward(dy))
        assert got == {"layer_norm_fwd": 1, "layer_norm_fwd.warp": 1,
                       "layer_norm_bwd_dx": 1, "layer_norm_bwd_dx.warp": 1}
    for c in (7, 1028):
        x, dy, s, b = _ln_inputs(dev, 15, 16, c, torch.float32)
        assert routes(lambda: ln._fwd_kernel(x, s, b, 1e-12)) == {
            "layer_norm_fwd": 1, "layer_norm_fwd.row": 1}


def _dal_inputs(dev, seed, r, c, dtype):
    g = _g(seed)
    x, res, dy = (torch.randn(r, c, generator=g, device=dev).to(dtype)
                  for _ in range(3))
    s = 1 + 0.1 * torch.randn(c, generator=g, device=dev)
    b = 0.1 * torch.randn(c, generator=g, device=dev)
    return x, res, dy, s, b


def _dal_launches(fn):
    """fn()'s result and the launches of rows 6-7 it made, by counter."""
    from paddle_tpu_torch.ops import _build
    before = _build.launch_counts()
    out = fn()
    torch.cuda.synchronize()
    after = _build.launch_counts()
    return out, {k: after[k] - before.get(k, 0) for k in after
                 if k.startswith("dropout_add_ln")
                 and after[k] != before.get(k, 0)}


@pytest.mark.parametrize("view", ["chosen", "misaligned"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("r,c", LN_ROW_SHAPES)
def test_dropout_add_ln_kernels_match_plain(dev, dtype, p, r, c, view):
    """Both routes against the plain versions: f32 1e-4, bf16 2e-2,
    mean 1e-5, rstd 1e-4; the route ln_route picks ("chosen") and, on
    misaligned copies of x, res, z and dy, the row route. The masks are
    bit-equal. Each launch counts under its kernel and its route."""
    from paddle_tpu_torch.ops import fused_residual as fr
    from paddle_tpu_torch.ops.layer_norm import ln_route
    x, res, dy, s, b = _dal_inputs(dev, 10, r, c, dtype)
    if view == "misaligned":
        x, res, dy = (_ln_misaligned(t) for t in (x, res, dy))
    took = ln_route(c, dtype, fr._ptrs(x, res, s, b))
    assert view == "chosen" or took == "row"
    seed = -1234567
    (y, z, mean, rstd), got = _dal_launches(
        lambda: fr._fwd_kernel(x, res, s, b, seed, p, 1e-12))
    assert got == {"dropout_add_ln_fwd": 1, f"dropout_add_ln_fwd.{took}": 1}
    zk = _ln_misaligned(z) if view == "misaligned" else z
    (dx, dres), got = _dal_launches(
        lambda: fr._bwd_kernel(zk, s, mean, rstd, dy, seed, p))
    assert got == {"dropout_add_ln_bwd": 1, f"dropout_add_ln_bwd.{took}": 1}
    if c == 1:      # one column: variance 0, rstd = rsqrt(eps) = 1e6
        torch.testing.assert_close(rstd, torch.full_like(rstd, 1e6),
                                   rtol=1e-5, atol=0)
        return
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


def _dal_both_routes(x, res, dy):
    """(route, x, res, dy) for the warp route (the aligned inputs) and
    the row route (misaligned copies)."""
    return [("warp", x, res, dy),
            ("row", *(_ln_misaligned(t) for t in (x, res, dy)))]


def _dal_run(fr, x, res, dy, s, b, p, route):
    """Forward then backward of rows 6-7 on `route` (z re-copied off a
    16-byte boundary for the row route): (y, z, mean, rstd, dx, dres)."""
    y, z, mean, rstd = fr._fwd_kernel(x, res, s, b, 99, p, 1e-12)
    zk = z if route == "warp" else _ln_misaligned(z)
    return (y, z, mean, rstd,
            *fr._bwd_kernel(zk, s, mean, rstd, dy, 99, p))


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,c", [(304, 768), (2048, 768), (5, 1024)])
def test_dropout_add_ln_routes_are_bit_equal_run_to_run(dev, dtype, r, c,
                                                        p):
    """Each route gives the same bits twice (sums in a fixed order, the
    mask replayed from the seed)."""
    from paddle_tpu_torch.ops import fused_residual as fr
    x, res, dy, s, b = _dal_inputs(dev, 16, r, c, dtype)
    for route, xr, rr, dyr in _dal_both_routes(x, res, dy):
        runs = [_dal_launches(lambda: _dal_run(fr, xr, rr, dyr, s, b, p,
                                               route)) for _ in range(2)]
        for out, got in runs:
            assert got == {
                "dropout_add_ln_fwd": 1, f"dropout_add_ln_fwd.{route}": 1,
                "dropout_add_ln_bwd": 1, f"dropout_add_ln_bwd.{route}": 1}
        for a, w in zip(runs[0][0], runs[1][0]):
            assert torch.equal(a, w), route


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_add_ln_zero_variance_row_on_both_routes(dev, dtype):
    """x = 0 and a residual row of equal values: z has variance exactly
    0 (two-pass statistics), rstd = rsqrt(1e-12) = 1e6, y = bias, finite
    gradients; on both routes, with dropout on."""
    from paddle_tpu_torch.ops import fused_residual as fr
    x, res, dy, s, b = _dal_inputs(dev, 17, 4, 768, dtype)
    x[0] = 0
    res[0] = -1.5
    for route, xr, rr, dyr in _dal_both_routes(x, res, dy):
        (y, z, mean, rstd, dx, dres), got = _dal_launches(
            lambda: _dal_run(fr, xr, rr, dyr, s, b, 0.1, route))
        assert got[f"dropout_add_ln_fwd.{route}"] == 1
        assert float(mean[0]) == -1.5, route
        torch.testing.assert_close(rstd[0], torch.tensor(1e6, device=dev),
                                   rtol=1e-5, atol=0)
        assert torch.equal(y[0], b.to(dtype)), route
        assert bool(torch.isfinite(dx.float()).all()), route
        assert bool(torch.isfinite(dres.float()).all()), route


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_add_ln_p0_backward_writes_one_gradient(dev, dtype):
    """At p = 0 the backward is one launch that writes dres alone (the
    wrapper allocates no dx and returns dres as both), on both routes;
    through autograd, x.grad and res.grad equal the plain version's and
    are separate tensors."""
    from paddle_tpu_torch.ops import fused_residual as fr
    x, res, dy, s, b = _dal_inputs(dev, 18, 64, 768, dtype)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for route, xr, rr, dyr in _dal_both_routes(x, res, dy):
        out, got = _dal_launches(
            lambda: _dal_run(fr, xr, rr, dyr, s, b, 0.0, route))
        assert got["dropout_add_ln_bwd"] == 1
        assert got[f"dropout_add_ln_bwd.{route}"] == 1
        dx, dres = out[4:]
        assert dx is dres, route
        _, _, mean, rstd = out[:4]
        _, dres_r = fr.dropout_add_ln_bwd_reference(out[1], s, mean, rstd,
                                                    dyr, 99, 0.0)
        torch.testing.assert_close(dres.float(), dres_r.float(), atol=tol,
                                   rtol=tol)
    xt, rt = (t.clone().requires_grad_() for t in (x, res))
    fr.fused_dropout_add_ln(xt, rt, s, b, 3, 0.0, 1e-12).backward(dy)
    xc, rc = (t.cpu().clone().requires_grad_() for t in (x, res))
    fr.fused_dropout_add_ln(xc, rc, s.cpu(), b.cpu(), 3, 0.0,
                            1e-12).backward(dy.cpu())
    for a, w in ((xt.grad, xc.grad), (rt.grad, rc.grad)):
        torch.testing.assert_close(a.float().cpu(), w.float(), atol=tol,
                                   rtol=tol)
    assert torch.equal(xt.grad, rt.grad)
    assert xt.grad.data_ptr() != rt.grad.data_ptr()


def test_dropout_add_ln_routes_by_width_dtype_and_alignment(dev):
    """The route each call takes, read from the counters: BERT's C = 768
    and the cap C = 1024 in f32 and bf16 on "warp" (both p), a
    misaligned x on "row", C = 7 and one vector past the cap on "row";
    the autograd Function takes the same routes."""
    from paddle_tpu_torch.ops import fused_residual as fr
    for dtype in (torch.float32, torch.bfloat16):
        for c in (768, 1024):
            x, res, dy, s, b = _dal_inputs(dev, 19, 16, c, dtype)
            for p in (0.0, 0.1):
                (_, z, mean, rstd), got = _dal_launches(
                    lambda: fr._fwd_kernel(x, res, s, b, 5, p, 1e-12))
                assert got == {"dropout_add_ln_fwd": 1,
                               "dropout_add_ln_fwd.warp": 1}
                _, got = _dal_launches(
                    lambda: fr._bwd_kernel(z, s, mean, rstd, dy, 5, p))
                assert got == {"dropout_add_ln_bwd": 1,
                               "dropout_add_ln_bwd.warp": 1}
        x, res, dy, s, b = _dal_inputs(dev, 20, 16, 768, dtype)
        xm = _ln_misaligned(x)
        _, got = _dal_launches(
            lambda: fr._fwd_kernel(xm, res, s, b, 5, 0.1, 1e-12))
        assert got == {"dropout_add_ln_fwd": 1, "dropout_add_ln_fwd.row": 1}
        xt = x.clone().requires_grad_()
        _, got = _dal_launches(lambda: fr.fused_dropout_add_ln(
            xt, res, s, b, 5, 0.1, 1e-12).backward(dy))
        assert got == {"dropout_add_ln_fwd": 1, "dropout_add_ln_fwd.warp": 1,
                       "dropout_add_ln_bwd": 1, "dropout_add_ln_bwd.warp": 1}
        past = 1028 if dtype == torch.float32 else 1032
        for c in (7, past):
            x, res, dy, s, b = _dal_inputs(dev, 21, 16, c, dtype)
            _, got = _dal_launches(
                lambda: fr._fwd_kernel(x, res, s, b, 5, 0.1, 1e-12))
            assert got == {"dropout_add_ln_fwd": 1,
                           "dropout_add_ln_fwd.row": 1}


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


@pytest.mark.parametrize("act", ["gelu", "gelu_tanh", "relu"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,h,i", [(300, 768, 3072), (64, 2048, 512),
                                   (33, 4096, 256)])
def test_fused_ffn_simt_column_tiles_misaligned(dev, m, h, i, dt, act):
    """The wide-H shapes of test_fused_ffn_kernel_matches_plain with x 8
    bytes off a 16-byte boundary, so that both dtypes take the SIMT
    kernel and its H column tiles, which the aligned bf16 (and 300-row
    f32) calls no longer reach: within tolerance of the plain version,
    identical bits when run again."""
    from paddle_tpu_torch.ops.fused_ffn import ffn_reference, fused_ffn
    args = _ffn_args(dev, 16, m, h, i, dt)
    shift = _misaligned_f32 if dt == torch.float32 else _misaligned
    off = (shift(args[0]), *args[1:])
    got, routes = _counted("fused_ffn", lambda: fused_ffn(*off, act))
    assert routes == {"tc": 0, "simt": 1, "ffma": 0}
    assert torch.equal(got, fused_ffn(*off, act))
    tol = 1e-4 if dt == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), ffn_reference(*args, act).float(),
                               atol=tol, rtol=tol)


FFN_ROUTE_CASES = [  # m, h, i, dtype, route
    (8192, 768, 3072, torch.float32, "ffma"),    # the static FFN preset
    (200, 768, 3072, torch.float32, "ffma"),     # M not a tile multiple
    (300, 128, 512, torch.float32, "ffma"),
    (1000, 256, 1024, torch.bfloat16, "tc"),
    (37, 192, 320, torch.bfloat16, "tc"),        # TMA zero-fills past M
    (1024, 2048, 8192, torch.bfloat16, "tc"),    # GPT-3 XL width
]


def _ffn_args(dev, seed, m, h, i, dt):
    g = _g(seed)
    return (torch.randn(m, h, generator=g, device=dev).to(dt),
            (torch.randn(h, i, generator=g, device=dev) * 0.05).to(dt),
            (torch.randn(i, generator=g, device=dev) * 0.1).to(dt),
            (torch.randn(i, h, generator=g, device=dev) * 0.05).to(dt),
            (torch.randn(h, generator=g, device=dev) * 0.1).to(dt))


@pytest.mark.parametrize("act", ["gelu", "gelu_tanh", "relu"])
@pytest.mark.parametrize("m,h,i,dt,route", FFN_ROUTE_CASES)
def test_fused_ffn_routes_match_plain(dev, m, h, i, dt, route, act):
    """fused_ffn on its tensor-core (bf16) and FFMA (f32 from 128 rows)
    routes: one launch of the expected route, within tolerance of
    ffn_reference (f32 1e-4 + 1e-4 |ref|: sums of up to 8192 terms in
    another order; bf16 2e-2 + 2e-2 |ref|: hid and y rounded once each
    on both sides), and the same bits when run again."""
    from paddle_tpu_torch.ops.fused_ffn import ffn_reference, fused_ffn
    args = _ffn_args(dev, 12, m, h, i, dt)
    got, routes = _counted("fused_ffn", lambda: fused_ffn(*args, act))
    assert routes == {r: int(r == route) for r in ("tc", "simt", "ffma")}
    want = ffn_reference(*args, act)
    tol = 1e-4 if dt == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert torch.equal(got, fused_ffn(*args, act))


@pytest.mark.parametrize("m,h,i,dt", [(256, 768, 3072, torch.float32),
                                      (1000, 256, 1024, torch.bfloat16)])
def test_fused_ffn_bias_epilogue_equals_the_residual_one(dev, m, h, i, dt):
    """fused_ffn's down product (epilogue MODE 2: bias, no residual, no
    dropout) gives the bits of fused_ffn_ln's (MODE 1) with a zero
    residual, norm "none" and p = 0, on the same route and tiles: the
    GEMM cores the two files share compute one function."""
    from paddle_tpu_torch.ops.fused_block import fused_ffn_ln
    from paddle_tpu_torch.ops.fused_ffn import fused_ffn
    args = _ffn_args(dev, 13, m, h, i, dt)
    y, r1 = _counted("fused_ffn", lambda: fused_ffn(*args, "gelu_tanh"))
    z, r2 = _counted("fused_ffn_ln", lambda: fused_ffn_ln(
        *args, torch.zeros_like(args[0])))
    assert r1 == {r: r2[r] for r in r1} and r2["stream"] == 0
    assert r1["simt"] == 0
    assert torch.equal(y, z)


def test_fused_ffn_routes_by_dtype_rows_width_and_alignment(dev):
    """f32 under 128 rows, H not a multiple of 64 and a misaligned x take
    the SIMT kernel, still within tolerance of the plain version."""
    from paddle_tpu_torch.ops.fused_ffn import ffn_reference, fused_ffn
    for m, h, i, dt in ((64, 768, 3072, torch.float32),
                        (256, 96, 512, torch.float32),
                        (256, 96, 512, torch.bfloat16)):
        args = _ffn_args(dev, 14, m, h, i, dt)
        got, routes = _counted("fused_ffn", lambda: fused_ffn(*args))
        assert routes == {"tc": 0, "simt": 1, "ffma": 0}
        tol = 1e-4 if dt == torch.float32 else 2e-2
        torch.testing.assert_close(got.float(), ffn_reference(*args).float(),
                                   atol=tol, rtol=tol)
    for dt in (torch.float32, torch.bfloat16):
        args = _ffn_args(dev, 15, 256, 768, 3072, dt)
        shift = _misaligned_f32 if dt == torch.float32 else _misaligned
        off = (shift(args[0]), *args[1:])
        got, routes = _counted("fused_ffn", lambda: fused_ffn(*off))
        assert routes == {"tc": 0, "simt": 1, "ffma": 0}
        tol = 1e-4 if dt == torch.float32 else 2e-2
        torch.testing.assert_close(got.float(), ffn_reference(*args).float(),
                                   atol=tol, rtol=tol)


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


# ---------------------------------------------------------------------------
# B rows 4-5: the flash kernels' two routes (ops/flash_attention.py
# flash_tc_route): bf16 at D = 64 or 128 with aligned operands on the
# tensor cores, the rest on the SIMT kernels
# ---------------------------------------------------------------------------

def _misaligned(x):
    """A contiguous copy of x 8 bytes past a 16-byte boundary: what TMA
    cannot read, so the call takes the SIMT route."""
    flat = torch.empty(x.numel() + 4, dtype=x.dtype, device=x.device)
    y = flat[4:].view(x.shape)
    y.copy_(x)
    assert y.is_contiguous() and y.data_ptr() % 16 == 8
    return y


def _flash_case(dev, seed, b, h, s, t, d, with_mask):
    g = _g(seed)
    bf = torch.bfloat16
    q, k, v, do = (torch.randn(b * h, n, d, generator=g, device=dev).to(bf)
                   for n in (s, t, t, s))
    mask2 = None
    if with_mask:   # row i pads its last 3 i keys (row 0 none)
        mask2 = torch.zeros(b, t, device=dev)
        for i in range(1, b):
            mask2[i, t - 3 * i:] = -1e9
    return q, k, v, do, mask2


def _flash_routes(q, k, v, do, tail):
    """The three kernels on q, k, v, do, with the route each took."""
    from paddle_tpu_torch.ops import flash_attention as fa
    (o, lse), r_fwd = _counted("flash_fwd",
                               lambda: fa._fwd_kernel(q, k, v, *tail))
    delta = fa.bwd_delta(o, do)
    args = (q, k, v, do, lse, delta, *tail)
    dq, r_dq = _counted("flash_bwd_dq", lambda: fa._dq_kernel(*args))
    (dk, dv), r_dkv = _counted("flash_bwd_dkv", lambda: fa._dkv_kernel(*args))
    return (o, lse, dq, dk, dv), (r_fwd, r_dq, r_dkv)


def _assert_bf16_close(got, want, name):
    """2e-2 + 2e-2 |ref| everywhere, and at most 1% of the elements not
    the same bf16 number (another order of f32 sums; where a rounding of
    P or dS lands on the other side)."""
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2, msg=name)
    assert (got != want).float().mean().item() <= 0.01, name


FLASH_TC_CASES = [  # b, h, s, t, d, causal, mask, p
    (1, 16, 1024, 1024, 128, True, False, 0.0),   # GPT-3 XL
    (16, 12, 128, 128, 64, False, False, 0.1),    # BERT-base
    (16, 12, 128, 128, 64, False, True, 0.1),     # BERT-base, padded
    (2, 3, 192, 192, 64, True, False, 0.0),       # S, T % 128 == 64
    (2, 3, 192, 192, 128, False, True, 0.1),
    (2, 2, 256, 256, 64, True, False, 0.0),       # D = 64 causal
    (1, 2, 512, 512, 128, False, False, 0.2),     # one 512-key block
    (2, 2, 64, 192, 64, True, False, 0.0),        # S < T
    (2, 2, 192, 128, 128, False, True, 0.1),      # S > T
]


@pytest.mark.parametrize("route", ["tc", "simt"])
@pytest.mark.parametrize("b,h,s,t,d,causal,with_mask,p", FLASH_TC_CASES)
def test_flash_bf16_routes_match_plain(dev, route, b, h, s, t, d, causal,
                                       with_mask, p):
    """bf16 through the tensor cores (aligned operands) and through the
    SIMT kernels (the same numbers 8 bytes off a 16-byte boundary), each
    kernel against its plain version: both round P, the dropped P and dS
    where the reference does, so the outputs are the same bf16 numbers
    but for a few; lse within 1e-4; two runs bit-identical."""
    from paddle_tpu_torch.ops import flash_attention as fa
    q, k, v, do, mask2 = _flash_case(dev, 30, b, h, s, t, d, with_mask)
    if route == "simt":
        q, k, v, do = (_misaligned(x) for x in (q, k, v, do))
    tail = (d ** -0.5, causal, mask2, 77, p)
    got, routes = _flash_routes(q, k, v, do, tail)
    for r in routes:
        assert r == {"tc": int(route == "tc"), "simt": int(route == "simt"),
                     "ffma": 0}
    o, lse, dq, dk, dv = got
    o_r, lse_r = fa.flash_fwd_reference(q, k, v, *tail)
    torch.testing.assert_close(lse, lse_r, atol=1e-4, rtol=1e-4)
    _assert_bf16_close(o, o_r, "o")
    plain = (q, k, v, o, lse, do, *tail)
    _assert_bf16_close(dq, fa.bwd_dq_reference(*plain), "dq")
    dk_r, dv_r = fa.bwd_dkv_reference(*plain)
    _assert_bf16_close(dk, dk_r, "dk")
    _assert_bf16_close(dv, dv_r, "dv")
    again, _ = _flash_routes(q, k, v, do, tail)
    for x, y in zip(got, again):
        assert torch.equal(x, y)


@pytest.mark.parametrize("route", ["tc", "simt"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_routes_round_at_the_reference_block_override(
        dev, route, causal, monkeypatch):
    """Fault C3: with PADDLE_TPU_FLASH_BLOCK_Q / _K at 64 the reference
    rounds P at 64-key blocks of T = 1024 (not 512), and so do the plain
    versions (ref_block) and both routes: o at most 1% of its elements
    another bf16 number. The gradients round dS elementwise whatever the
    block: within 2e-2 + 2e-2 |ref|, and no more elements off than at
    the default block (+ 0.5%). A block the kernels cannot round at
    raises before the launch."""
    from paddle_tpu_torch.ops import flash_attention as fa
    for name in ("PADDLE_TPU_FLASH_BLOCK_Q", "PADDLE_TPU_FLASH_BLOCK_K"):
        monkeypatch.delenv(name, raising=False)
    q, k, v, do, _ = _flash_case(dev, 32, 1, 2, 1024, 1024, 64, False)
    if route == "simt":
        q, k, v, do = (_misaligned(x) for x in (q, k, v, do))
    tail = (64 ** -0.5, causal, None, 0, 0.0)

    def off():
        got, routes = _flash_routes(q, k, v, do, tail)
        for r in routes:
            assert r[route] == 1
        o_r, lse_r = fa.flash_fwd_reference(q, k, v, *tail)
        ref = (o_r, *fa.flash_bwd_reference(q, k, v, o_r, lse_r, do, *tail))
        out = []
        for x, y in zip((got[0], *got[2:]), ref):
            torch.testing.assert_close(x.float(), y.float(), atol=2e-2,
                                       rtol=2e-2)
            out.append((x != y).float().mean().item())
        return out

    base = off()
    monkeypatch.setenv("PADDLE_TPU_FLASH_BLOCK_Q", "64")
    monkeypatch.setenv("PADDLE_TPU_FLASH_BLOCK_K", "64")
    assert fa.ref_block(1024) == 64
    knob = off()
    assert knob[0] <= 0.01
    for a, b in zip(knob[1:], base[1:]):
        assert a <= max(0.01, b + 0.005)
    monkeypatch.setenv("PADDLE_TPU_FLASH_BLOCK_K", "32")
    with pytest.raises(ValueError, match="PADDLE_TPU_FLASH_BLOCK_K"):
        fa._fwd_kernel(q, k, v, *tail)


@pytest.mark.parametrize("d", [64, 128])
def test_flash_tensor_core_dropout_masks_are_bit_equal(dev, d):
    """Identity blocks expose the dropped probabilities: V = I makes o the
    dropped P (forward), dO = I makes dv the dropped P^T (dK/dV kernel);
    their zeros are keep_mask_salted's, so the fragment map and the
    transposed coordinates of the dK/dV kernel hash (q row, key)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    bf = torch.bfloat16
    g = _g(31)
    bh, t, p, seed = 6, 2 * d, 0.1, -5
    q = (torch.randn(bh, t, d, generator=g, device=dev) * 0.3).to(bf)
    k = (torch.randn(bh, t, d, generator=g, device=dev) * 0.3).to(bf)
    keep = fa.keep_mask_salted(seed, bh, t, t, p, dev)
    eye = torch.eye(d, device=dev, dtype=bf)
    for half in (0, 1):
        v = torch.zeros(bh, t, d, device=dev, dtype=bf)
        v[:, half * d:(half + 1) * d] = eye
        (o, lse), routes = _counted("flash_fwd", lambda: fa._fwd_kernel(
            q, k, v, d ** -0.5, False, None, seed, p))
        assert routes == {"tc": 1, "simt": 0, "ffma": 0}
        assert torch.equal(o != 0, keep[:, :, half * d:(half + 1) * d])
        do = torch.zeros(bh, t, d, device=dev, dtype=bf)
        do[:, half * d:(half + 1) * d] = eye
        delta = fa.bwd_delta(o, do)
        (dk, dv), routes = _counted("flash_bwd_dkv", lambda: fa._dkv_kernel(
            q, k, v, do, lse, delta, d ** -0.5, False, None, seed, p))
        assert routes == {"tc": 1, "simt": 0, "ffma": 0}
        want = keep[:, half * d:(half + 1) * d, :].transpose(1, 2)
        assert torch.equal(dv != 0, want)


def test_flash_routes_by_dtype_head_dim_and_alignment(dev):
    """bf16 at D in {64, 128} takes the tensor cores; f32, D = 96 and
    256 and a misaligned view take the SIMT kernels, which still match
    the plain version (f32 1e-4; bf16 as above)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    bf, f32 = torch.bfloat16, torch.float32
    for d, dt, want in ((64, bf, "tc"), (128, bf, "tc"), (64, f32, "simt"),
                        (128, f32, "simt"), (96, bf, "simt"),
                        (256, bf, "simt")):
        q, k, v, do, _ = _flash_case(dev, 32, 1, 2, 128, 128, d, False)
        q, k, v, do = (x.to(dt) for x in (q, k, v, do))
        tail = (d ** -0.5, True, None, 0, 0.0)
        got, routes = _flash_routes(q, k, v, do, tail)
        for r in routes:
            assert r[want] == 1 and sum(r.values()) == 1, (d, dt, r)
        o_r, _ = fa.flash_fwd_reference(q, k, v, *tail)
        want_b = fa.flash_bwd_reference(q, k, v, got[0], got[1], do, *tail)
        for x, y, name in zip((got[0], *got[2:]), (o_r, *want_b),
                              ("o", "dq", "dk", "dv")):
            if dt == torch.float32:
                torch.testing.assert_close(x, y, atol=1e-4, rtol=1e-4)
            else:
                _assert_bf16_close(x, y, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_attention_two_ranks_on_the_card_match_dense(dev, tmp_path,
                                                          dtype):
    """Ring attention over two ranks sharing the card (gloo; the hops
    through host copies) on CUDA tensors: each rank's output shard, the
    summed loss and the q/k/v gradient shards against the dense
    function on the whole sequence on the card. f32 at the CPU test's
    tolerance (atol 2e-4, rtol 1e-3); bf16 at 2e-2 + 2e-2 |ref| (the
    ring and the dense function round P and the output to bf16 at
    other points of the online softmax)."""
    import os
    import pickle
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    import torch_hybrid_workers as W
    from paddle_tpu_torch.distributed import spawn
    from paddle_tpu_torch.parallel.sequence_parallel import _dense
    spawn(W.run, args=(str(tmp_path), [("ring", "ring", (
        {"sp": 2}, True, 256, "cuda", dtype))]), nprocs=2, timeout=120)
    ranks = []
    for r in range(2):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f)["ring"])
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(dev, dt).requires_grad_()
               for a in W.qkv(S=256))
    o = _dense(q, k, v, True, 0.25)
    loss = torch.sum(o.float() ** 2)
    grads = torch.autograd.grad(loss, (q, k, v))
    loss = loss.item()
    tol = dict(atol=2e-4, rtol=1e-3) if dtype == "float32" else \
        dict(atol=2e-2, rtol=2e-2)
    got = sum(r["loss"] for r in ranks)
    assert abs(got - loss) <= (1e-5 if dtype == "float32" else 2e-2) \
        * abs(loss)
    for r, res in enumerate(ranks):
        assert res["sp"] == r and res["device"].startswith("cuda")
        want = o.float()[:, :, r * 128:(r + 1) * 128].cpu()
        torch.testing.assert_close(torch.from_numpy(res["out"]), want,
                                   **tol)
    for i, g in enumerate(grads):
        whole = torch.cat([torch.from_numpy(r["grads"][i]) for r in ranks],
                          2)
        torch.testing.assert_close(whole, g.float().cpu(), **tol)

"""Ragged paged attention in the port (paddle_tpu_torch/ops/
paged_attention.py) against the JAX package's gather path
(paged_attention_xla) and its Pallas kernel in interpret mode, on the
same numpy inputs: ragged ctx, ctx = 1, rows padded with the trash page,
float32 and bfloat16 caches. On the CPU the port's entry point runs its
plain version; the CUDA kernel is checked against that same plain
version on the card (chip_smoke.py)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.paged_attention import (paged_attention_pallas,
                                            paged_attention_xla)
from paddle_tpu_torch.ops import paged_attention as port

# float32: the sums run in another order than in XLA
TOL_F32 = dict(atol=1e-5, rtol=1e-5)
# bfloat16 cache: the gather path rounds the probabilities and the
# output to bfloat16 (8 significant bits, relative step 2^-8 = 0.0039)
# at other places than the Pallas kernel, which stays in f32; outputs
# are O(1), so allow a few bf16 steps
TOL_BF16 = dict(atol=2e-2, rtol=2e-2)


def _inputs(S=4, H=2, d=64, P=12, ps=8, M=4, ctx=(1, 5, 17, 32), seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(S, H, d).astype(np.float32)
    k = rng.randn(P + 1, ps, H, d).astype(np.float32)
    v = rng.randn(P + 1, ps, H, d).astype(np.float32)
    pt = rng.randint(0, P, (S, M)).astype(np.int32)
    ln = np.asarray(ctx, np.int32)
    # unused table entries point at the trash page (index P), as the
    # engine pads them
    for s in range(S):
        pt[s, -(-int(ln[s]) // ps):] = P
    return q, k, v, pt, ln


def _both(q, k, v, pt, ln, dtype):
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    t = (torch.from_numpy(q), torch.from_numpy(k).to(tdt),
         torch.from_numpy(v).to(tdt), torch.from_numpy(pt),
         torch.from_numpy(ln))
    j = (jnp.asarray(q), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
         jnp.asarray(pt), jnp.asarray(ln))
    return t, j


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ref", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("ctx", [(1, 5, 17, 32), (1, 1, 1, 1),
                                 (32, 8, 9, 2)])
def test_paged_attention_matches_jax(dtype, ref, ctx):
    q, k, v, pt, ln = _inputs(ctx=ctx)
    t, j = _both(q, k, v, pt, ln, dtype)
    got = port.paged_attention_decode(*t).numpy()
    if ref == "xla":
        want = np.asarray(paged_attention_xla(*j))
    else:
        want = np.asarray(paged_attention_pallas(*j, interpret=True))
    assert got.dtype == np.float32 and got.shape == q.shape
    np.testing.assert_allclose(got, want, **(
        TOL_F32 if dtype == "float32" else TOL_BF16))


def test_paged_attention_explicit_scale_and_trash_only_rows():
    """An explicit scale, and a slot whose table is all trash page (an
    inactive slot: position 0, ctx 1)."""
    q, k, v, pt, ln = _inputs(ctx=(1, 3, 9, 24), seed=3)
    pt[0, :] = k.shape[0] - 1
    t, j = _both(q, k, v, pt, ln, "float32")
    got = port.paged_attention_decode(*t, scale=0.25).numpy()
    want = np.asarray(paged_attention_xla(*j, scale=0.25))
    np.testing.assert_allclose(got, want, **TOL_F32)


def test_paged_attention_head_dim_128_page_16():
    """The GPT-3 XL head geometry (d = 128, page_size 16)."""
    q, k, v, pt, ln = _inputs(S=3, H=2, d=128, P=10, ps=16, M=4,
                              ctx=(1, 40, 64), seed=5)
    t, j = _both(q, k, v, pt, ln, "float32")
    np.testing.assert_allclose(port.paged_attention_decode(*t).numpy(),
                               np.asarray(paged_attention_xla(*j)),
                               **TOL_F32)


def test_paged_attention_other_devices_raise():
    q, k, v, pt, ln = _inputs()
    meta = [torch.empty(a.shape, dtype=torch.from_numpy(a).dtype,
                        device="meta") for a in (q, k, v, pt, ln)]
    with pytest.raises(ValueError, match="no kernel"):
        port.paged_attention_decode(*meta)


@pytest.mark.parametrize("case", ["q_dtype", "cache_dtype", "table_dtype",
                                  "shape", "contiguous", "head_dim",
                                  "row_bytes"])
def test_kernel_argument_checks(case):
    """What neither CUDA kernel takes raises before any launch; float16
    pools, head_dim 256 and rows that are not whole 16-byte pieces go to
    the scalar kernel (the checks are plain Python, exercised here on CPU
    tensors)."""
    q, k, v, pt, ln = (torch.from_numpy(a) for a in _inputs())
    if case == "q_dtype":
        q = q.double()
    elif case == "cache_dtype":
        k, v = k.half(), v.half()
    elif case == "table_dtype":
        pt = pt.long()
    elif case == "shape":
        ln = ln[:2]
    elif case == "contiguous":
        k = k.transpose(2, 3)
    elif case == "head_dim":
        q = torch.zeros(4, 2, 256)
        k = v = torch.zeros(13, 8, 2, 256)
    elif case == "row_bytes":   # 60 bf16 = 120 bytes: not 16-byte rows
        q = torch.zeros(4, 2, 60)
        k = v = torch.zeros(13, 8, 2, 60, dtype=torch.bfloat16)
    if case in ("cache_dtype", "head_dim", "row_bytes"):
        assert port._check(q, k, v, pt, ln) == "scalar"
    else:
        with pytest.raises((TypeError, ValueError)):
            port._check(q, k, v, pt, ln)
    assert port._check(*(torch.from_numpy(a) for a in _inputs())) \
        == "vector"


# ---------------------------------------------------------------------------
# the split-context kernel's algorithm (paged_attention_split_reference) and
# its split rule (paged_splits)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,H,M,sms,want", [
    (8, 16, 128, 132, 10),    # GPT-3 XL decode: the serving engine's M
    (8, 16, 64, 132, 5),      # a 64-page pool
    (8, 16, 8, 132, 1),       # a short table: one split a page
    (8, 16, 2, 132, 1),
    (32, 16, 128, 132, 32),   # 512 (slot, head) pairs: four splits
    (64, 32, 128, 132, 128),  # 2048 pairs fill the card alone
    (1, 1, 4, 132, 1),
    (8, 16, 128, 114, 12)])   # a card of 114 SMs: eleven splits
def test_paged_splits(S, H, M, sms, want):
    """Pages a split from the table's shape and the SM count alone:
    twelve blocks an SM when every table is full, at most one split a
    page, and no split past the table."""
    pps = port.paged_splits(S, H, M, sms)
    assert pps == want
    splits = -(-M // pps)
    assert 1 <= splits <= M and (splits - 1) * pps < M
    assert S * H * splits >= 12 * sms or splits == M


def _split_inputs(ps, M, ctx, S=None, H=2, d=64, seed=7):
    """A table of M pages whose unused tail points at the trash page."""
    S = len(ctx)
    return _inputs(S=S, H=H, d=d, P=S * M, ps=ps, M=M, ctx=ctx, seed=seed)


# ctx 0, 1, one page, one page + 1, a slot that ends inside a split (with
# two pages a split: page 3 is the second of split 1), and the whole table
SPLIT_MIXES = [(8, 6, (0, 1, 8, 9, 27, 48)),
               (16, 5, (0, 1, 16, 17, 55, 80))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ref", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("pps", [1, 2, None])
@pytest.mark.parametrize("ps,M,ctx", SPLIT_MIXES)
def test_split_reference_matches_jax(dtype, ref, pps, ps, M, ctx):
    """The split-and-merge plain version against the Pallas kernel in
    interpret mode on every slot, and against the gather path on the
    slots with ctx > 0: the gather path softmaxes an all-masked row into
    the mean of V, where the Pallas kernel (and the port's kernel) give 0
    by the l == 0 -> 1 rule. f32 within 2e-5; bf16 within 2e-2 (the
    gather path rounds the probabilities to bf16, the kernel keeps f32)."""
    q, k, v, pt, ln = _split_inputs(ps, M, ctx)
    t, j = _both(q, k, v, pt, ln, dtype)
    # None: paged_splits' pick for this table on a card of 132 SMs
    pps = pps or port.paged_splits(q.shape[0], q.shape[1], M, 132)
    got = port.paged_attention_split_reference(*t, pages_per_split=pps)
    assert got.dtype == torch.float32 and got.shape == q.shape
    got = got.numpy()
    if ref == "xla":
        want = np.asarray(paged_attention_xla(*j))
        rows = ln > 0
    else:
        want = np.asarray(paged_attention_pallas(*j, interpret=True))
        rows = np.ones_like(ln, dtype=bool)
        np.testing.assert_array_equal(got[ln == 0], 0.0)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got[rows], want[rows], atol=tol, rtol=tol)


def test_split_reference_is_the_same_for_every_split():
    """The merge makes the split count a matter of rounding only: one
    split a page, two, and the whole table in one split agree."""
    q, k, v, pt, ln = _split_inputs(8, 6, (0, 1, 8, 9, 27, 48), seed=9)
    t = tuple(map(torch.from_numpy, (q, k, v, pt, ln)))
    outs = [port.paged_attention_split_reference(*t, pages_per_split=p)
            for p in (1, 2, 6)]
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], atol=2e-6, rtol=2e-6)


# ---------------------------------------------------------------------------
# the route of paged_attention_decode on the card: the vector kernel where
# paged_route says so, the scalar kernel for every other call
# ---------------------------------------------------------------------------

def _pools(P, ps, H, d, dtype, offset=0):
    """A K/V pool pair [P, ps, H, d], each viewed `offset` elements into
    its storage (offset 1 in float32: a pool 4 bytes off a 16-byte
    boundary)."""
    n = P * ps * H * d
    return tuple(torch.zeros(n + offset, dtype=dtype)[offset:]
                 .view(P, ps, H, d) for _ in range(2))


# (q dtype, pool dtype, d, ps, pool offset in elements, contiguous, route)
ROUTE_CASES = {
    "gpt3_xl_f32": (torch.float32, torch.float32, 128, 16, 0, True,
                    "vector"),
    "gpt3_xl_bf16": (torch.float32, torch.bfloat16, 128, 16, 0, True,
                     "vector"),
    "d64_ps128": (torch.float32, torch.float32, 64, 128, 0, True, "vector"),
    "d128_ps256": (torch.float32, torch.float32, 128, 256, 0, True,
                   "vector"),
    "d8_bf16": (torch.float32, torch.bfloat16, 8, 16, 0, True, "vector"),
    "d256_ps16": (torch.float32, torch.float32, 256, 16, 0, True, "scalar"),
    "d4_bf16": (torch.float32, torch.bfloat16, 4, 16, 0, True, "scalar"),
    "d6_f32": (torch.float32, torch.float32, 6, 16, 0, True, "scalar"),
    "q_bf16": (torch.bfloat16, torch.bfloat16, 128, 16, 0, True, "scalar"),
    "q_f16": (torch.float16, torch.float16, 64, 16, 0, True, "scalar"),
    "pools_f16": (torch.float32, torch.float16, 128, 16, 0, True, "scalar"),
    "pool_4_bytes_off": (torch.float32, torch.float32, 128, 16, 1, True,
                         "scalar"),
    "not_contiguous": (torch.float32, torch.float32, 128, 16, 0, False,
                       "scalar"),
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_paged_route(case):
    """The route's truth table: every call the vector kernel cannot take
    (head_dim past 128, K/V rows that are not whole 16-byte pieces, q not
    float32, float16 pools, pools off a 16-byte boundary or not
    contiguous) goes to the scalar kernel; the GPT-3 XL decode shapes and
    any page size take the vector kernel."""
    qdt, kvdt, d, ps, offset, contiguous, want = ROUTE_CASES[case]
    k, v = _pools(3, ps, 2, d, kvdt, offset)
    assert port.paged_route(qdt, kvdt, d, (k.data_ptr(), v.data_ptr()),
                            contiguous) == want


def test_paged_route_one_misaligned_pool():
    k, _ = _pools(3, 16, 2, 128, torch.float32)
    _, v = _pools(3, 16, 2, 128, torch.float32, offset=1)
    assert port.paged_route(torch.float32, torch.float32, 128,
                            (k.data_ptr(), v.data_ptr())) == "scalar"
    assert port.paged_route(torch.float32, torch.float32, 128,
                            (k.data_ptr(), k.data_ptr())) == "vector"


@pytest.mark.parametrize("qdt,kvdt,d,exc", [
    (torch.float64, torch.float32, 64, TypeError),
    (torch.float32, torch.float64, 64, TypeError),
    (torch.float32, torch.int8, 64, TypeError),
    (torch.float32, torch.float32, 16385, ValueError)])
def test_paged_route_raises_past_both_kernels(qdt, kvdt, d, exc):
    """What neither kernel takes raises before any launch."""
    with pytest.raises(exc):
        port.paged_route(qdt, kvdt, d, (0, 0))


@pytest.mark.parametrize("case", ["device", "table_dtype", "lens_dtype",
                                  "shape", "pools_differ"])
def test_malformed_calls_raise(case):
    """What no kernel serves raises before any route is taken."""
    q, k, v, pt, ln = (torch.from_numpy(a) for a in _inputs())
    if case == "device":
        k = k.to("meta")
    elif case == "table_dtype":
        pt = pt.long()
    elif case == "lens_dtype":
        ln = ln.long()
    elif case == "shape":
        pt = pt[:2]
    elif case == "pools_differ":
        v = v.to(torch.bfloat16)
    with pytest.raises((TypeError, ValueError)):
        port._check(q, k, v, pt, ln)


# the shapes of fault C2, which the reference serves and the vector kernel
# does not take (but d = 128 at ps = 256, which it now does): (d, ps, ctx,
# P, M)
WIDE_SHAPES = [(256, 16, (1, 17, 40, 64), 12, 4),
               (128, 256, (1, 256, 257, 512), 6, 2),
               (4, 16, (1, 16, 17, 64), 12, 4),
               (6, 16, (3, 15, 33, 64), 12, 4)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,ps,ctx,P,M", WIDE_SHAPES)
def test_wide_shapes_match_jax_decode(d, ps, ctx, P, M, dtype):
    """The shapes of fault C2 (d = 256 at ps = 16, d = 128 at ps = 256,
    d = 4 and d = 6), which the reference serves through
    paged_attention_xla: the port's paged_attention_decode against the
    JAX package's, same numpy inputs."""
    from paddle_tpu.ops.paged_attention import paged_attention_decode
    q, k, v, pt, ln = _inputs(S=len(ctx), H=2, d=d, P=P, ps=ps, M=M,
                              ctx=ctx, seed=13)
    t, j = _both(q, k, v, pt, ln, dtype)
    got = port.paged_attention_decode(*t).numpy()
    want = np.asarray(paged_attention_decode(*j))
    assert got.shape == q.shape
    np.testing.assert_allclose(got, want, **(
        TOL_F32 if dtype == "float32" else TOL_BF16))

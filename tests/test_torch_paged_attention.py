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
                                  "shape", "contiguous", "head_dim"])
def test_kernel_argument_checks(case):
    """What the CUDA kernel does not take raises before any launch (the
    checks are plain Python, exercised here on CPU tensors)."""
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
    with pytest.raises((TypeError, ValueError)):
        port._check(q, k, v, pt, ln)
    port._check(*(torch.from_numpy(a) for a in _inputs()))

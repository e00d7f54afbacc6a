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
# bfloat16 in, f32 arithmetic in both, one rounding of each output to
# bf16 (8 bits of mantissa, 2**-8 ~ 4e-3 relative); the Pallas kernel
# also rounds P and dS to bf16 before its products and the port does
# not, so outputs and gradients agree to a few bf16 steps
BF16_TOL = dict(atol=3e-2, rtol=3e-2)
B, H, D = 2, 2, 64


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
    with pytest.raises(NotImplementedError, match="slice 5"):
        pgpt._causal_attention(q, k, v, 2, impl="ring")


@pytest.mark.parametrize("shape", [(1, 2, 100, 64), (1, 2, 64, 12),
                                   (1, 2, 64, 264)])
def test_outside_the_domain_raises(shape):
    q = torch.zeros(shape)
    assert not port.can_use_flash(q, q, q)
    with pytest.raises(ValueError, match="multiples of 64"):
        port.flash_attention(q, q, q)


def test_mask_and_dropout_raise():
    q = torch.zeros(1, 2, 64, 64)
    with pytest.raises(NotImplementedError, match="BERT"):
        port.flash_attention(q, q, q, mask=torch.zeros(1, 1, 1, 64))
    with pytest.raises(NotImplementedError, match="BERT"):
        port.flash_attention(q, q, q, dropout_p=0.1)
    assert not port.can_use_flash(q, q, q, mask=torch.zeros(1, 1, 1, 64))


def test_other_devices_raise():
    q = torch.empty(1, 2, 64, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        port.flash_attention(q, q, q)

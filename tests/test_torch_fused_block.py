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
    a = _ffn_inputs(m)
    ones, zeros = np.ones(D, np.float32), np.zeros(D, np.float32)
    got = port.fused_ffn_ln(*_t(a))
    want = pb.ffn_ln_reference(*_j(a), jnp.asarray(ones),
                               jnp.asarray(zeros), SEED, "gelu_tanh",
                               "none", 0.0, 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


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


@pytest.mark.parametrize("kw", [dict(p=0.1), dict(act="gelu"),
                                dict(act="relu"), dict(norm="pre"),
                                dict(norm="post")])
def test_unported_variants_raise(kw):
    a = _t(_ffn_inputs(4))
    with pytest.raises(NotImplementedError, match="BERT"):
        port.fused_ffn_ln(*a, **kw)
    if set(kw) == {"p"}:
        with pytest.raises(NotImplementedError, match="BERT"):
            port.fused_out_ln(*_t(_out_ln_inputs(4)), p=0.1)


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
    splits cover K, and only a card-starving tile count splits."""
    kc = port.out_ln_split_k(m, k, n)
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

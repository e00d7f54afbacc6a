"""B row 10 in the port (paddle_tpu_torch/ops/fused_ffn.py) and the
`fused_ffn` op (paddle_tpu_torch/fluid/ops/nn_ops.py) against the JAX
package: the Pallas kernel of paddle_tpu/ops/pallas_ffn.py in interpret
mode and the reference's registered op, on the same numpy inputs. On the
CPU the port's wrapper runs its plain version; the CUDA kernel is held
to that on the card (tests/test_torch_cuda_kernels.py, chip_smoke.py)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu  # noqa: F401  (registers the reference's ops)
from paddle_tpu import common_ops as jco
from paddle_tpu.fluid import Executor as JExecutor
from paddle_tpu.fluid import framework as jfw
from paddle_tpu.fluid import layers as jlayers
from paddle_tpu.fluid import unique_name as jun
from paddle_tpu.fluid.scope import Scope as JScope
from paddle_tpu.fluid.scope import scope_guard as jscope_guard
from paddle_tpu.ops import pallas_ffn as jffn

import paddle_tpu_torch as pt
from paddle_tpu_torch import common_ops as tco
from paddle_tpu_torch.fluid import CPUPlace, Executor, scope_from_numpy
from paddle_tpu_torch.fluid import framework as tfw
from paddle_tpu_torch.fluid import layers as tlayers
from paddle_tpu_torch.fluid import unique_name as tun
from paddle_tpu_torch.fluid.scope import scope_guard
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import fused_ffn as port

ACTS = ("gelu", "gelu_tanh", "relu")


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")


def _inputs(m, h, i, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(m, h).astype("float32"),
            (rng.randn(h, i) * 0.05).astype("float32"),
            (rng.randn(i) * 0.1).astype("float32"),
            (rng.randn(i, h) * 0.05).astype("float32"),
            (rng.randn(h) * 0.1).astype("float32"))


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("i", [512, 1024])
def test_fused_ffn_matches_pallas_interpret(interpret, act, i):
    """Forward within 5e-5 and all five gradients within 2e-4 of the
    Pallas kernel in interpret mode and its custom_vjp (the JAX test's
    own tolerances, tests/test_pallas_kernels.py)."""
    m, h = 256, 128
    assert jffn.can_use_fused_ffn(m, h, i)
    arrs = _inputs(m, h, i)
    y_ref = jffn.fused_ffn(*map(jnp.asarray, arrs), act)
    g_ref = jax.grad(lambda *a: jnp.sum(jffn.fused_ffn(*a, act) ** 2),
                     argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, arrs))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrs]
    y = port.fused_ffn(*ts, act)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               atol=5e-5, rtol=5e-5)
    g = torch.autograd.grad((y ** 2).sum(), ts)
    for a, b in zip(g, g_ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4,
                                   rtol=2e-4)


def test_fused_ffn_keeps_leading_dims(interpret):
    arrs = _inputs(256, 128, 512, seed=3)
    x3 = arrs[0].reshape(4, 64, 128)
    want = jffn.fused_ffn(jnp.asarray(x3), *map(jnp.asarray, arrs[1:]))
    got = port.fused_ffn(torch.from_numpy(x3),
                         *map(torch.from_numpy, arrs[1:]))
    assert got.shape == (4, 64, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5,
                               rtol=5e-5)


@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_bf16_rounds_hid_as_the_reference(interpret, act):
    """bf16: the Pallas body rounds hid to x's type before the second
    product (pallas_ffn.py:134). Port and reference agree within 2e-2 +
    2e-2 |ref|; a plain chain that keeps hid in f32 is further from the
    reference than the port is, by a margin the rounding explains."""
    m, h, i = 256, 128, 512
    arrs = [a * 4 if k == 0 else a for k, a in enumerate(_inputs(m, h, i, 7))]
    bf = [jnp.asarray(a, jnp.bfloat16) for a in arrs]
    ref = np.asarray(jffn.fused_ffn(*bf, act).astype(jnp.float32))
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]
    got = port.fused_ffn(*tb, act).float().numpy()
    assert np.all(np.abs(got - ref) <= 2e-2 + 2e-2 * np.abs(ref))
    # without the rounding: hid kept in f32 through the second product
    f = [t.float() for t in tb]
    hid = port.ACTS[act][1](f[0] @ f[1] + f[2])
    unrounded = (hid @ f[3] + f[4]).to(torch.bfloat16).float().numpy()
    err_port = np.abs(got - ref).mean()
    err_unrounded = np.abs(unrounded - ref).mean()
    assert err_unrounded > 4 * err_port, (err_port, err_unrounded)


def test_gate_matches_the_reference_on_alignment(interpret):
    shapes = [(256, 128, 512), (512, 768, 3072), (8192, 768, 3072),
              (255, 128, 512), (256, 120, 512), (256, 128, 500),
              (256, 4096, 512), (256, 4224, 512), (1024, 2048, 8192)]
    for m, h, i in shapes:
        # the reference's VMEM budget is TPU-only: compare where it fits
        if jffn._pick_blocks(m, h, i, 4) is None and m % 256 == 0 \
                and h % 128 == 0 and i % 512 == 0 and h <= 4096:
            assert port.can_use_fused_ffn(m, h, i)
            continue
        assert port.can_use_fused_ffn(m, h, i) == \
            jffn.can_use_fused_ffn(m, h, i), (m, h, i)


def test_gate_switches(monkeypatch):
    assert port.can_use_fused_ffn(256, 128, 512)
    with F.composed_ops():
        assert not port.can_use_fused_ffn(256, 128, 512)
    monkeypatch.setenv("PADDLE_TPU_DISABLE_FFN_FUSION", "1")
    assert not port.can_use_fused_ffn(256, 128, 512)
    monkeypatch.delenv("PADDLE_TPU_DISABLE_FFN_FUSION")
    monkeypatch.setenv("PADDLE_TPU_DISABLE_PALLAS", "1")
    assert not port.can_use_fused_ffn(256, 128, 512)
    assert port.ffn_wins(256, 128, 512, torch.float32)


def test_cuda_tensor_without_card_raises(monkeypatch):
    """A tensor routed to the kernel reaches the build, which raises on a
    host without nvcc: no fallback to the plain version, no launch."""
    monkeypatch.setattr(port, "_route", lambda t, what: True)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/usr/bin:/bin")
    before = _build.launch_counts().get("fused_ffn", 0)
    with pytest.raises(RuntimeError, match="nvcc"):
        port.fused_ffn(*map(torch.from_numpy, _inputs(256, 128, 512)))
    assert _build.launch_counts().get("fused_ffn", 0) == before
    monkeypatch.undo()
    with pytest.raises(ValueError, match="no kernel"):
        port.fused_ffn(torch.zeros(2, 4, device="meta"),
                       *map(torch.from_numpy, _inputs(1, 4, 8)[1:]))


def test_unknown_activation_raises():
    with pytest.raises(ValueError, match="gelu"):
        port.fused_ffn(*map(torch.from_numpy, _inputs(4, 8, 16)), "swish")


# ---------------------------------------------------------------------------
# the op, eager and in a static program
# ---------------------------------------------------------------------------

def _op_inputs(m, h, i, seed=1):
    rng = np.random.RandomState(seed)
    return {"X": rng.randn(m, h).astype("float32"),
            "W1": (rng.randn(h, i) * 0.05).astype("float32"),
            "B1": (rng.randn(i) * 0.1).astype("float32"),
            "W2": (rng.randn(i, h) * 0.05).astype("float32"),
            "B2": (rng.randn(h) * 0.1).astype("float32")}


def _jax_op(ins, act):
    """The reference's op through its static program and executor on the
    CPU (the composed fallback off a TPU, or the Pallas body in interpret
    mode when the gate admits it)."""
    paddle_tpu.enable_static()
    try:
        with jun.guard():
            main, startup = jfw.Program(), jfw.Program()
            with jfw.program_guard(main, startup):
                vs = {k: jlayers.data(k, list(v.shape), "float32")
                      for k, v in ins.items()}
                y = jco.run_op("fused_ffn", vs, {"activation": act})
        with jscope_guard(JScope()):
            return JExecutor(paddle_tpu.fluid.CPUPlace()).run(
                main, feed=ins, fetch_list=[y])[0]
    finally:
        paddle_tpu.disable_static()


def _port_static(ins, act):
    pt.enable_static()
    try:
        with tun.guard():
            main, startup = tfw.Program(), tfw.Program()
            with tfw.program_guard(main, startup):
                vs = {k: tlayers.data(k, list(v.shape), "float32")
                      for k, v in ins.items()}
                y = tco.run_op("fused_ffn", vs, {"activation": act})
        return Executor(CPUPlace()).run(main, feed=ins, fetch_list=[y])[0]
    finally:
        pt.disable_static()


@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_op_fallback_matches_reference_op(act):
    """4 x 60 is not aligned: both ops take the composed chain (exact
    gelu), eager and static, within 2e-5 (the reference's own test)."""
    ins = _op_inputs(4, 60, 120)
    want = _jax_op(ins, act)
    eager = tco.run_op("fused_ffn", {k: torch.from_numpy(v)
                                     for k, v in ins.items()},
                       {"activation": act})
    np.testing.assert_allclose(eager.numpy(), want, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(_port_static(ins, act), want, atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_op_aligned_matches_reference_pallas_path(interpret, act):
    """At 256 x 128 x 512 the reference's op reaches its Pallas body (in
    interpret mode) and the port's reaches ops.fused_ffn; eager and
    static agree with it within 5e-5."""
    ins = _op_inputs(256, 128, 512)
    want = _jax_op(ins, act)
    eager = tco.run_op("fused_ffn", {k: torch.from_numpy(v)
                                     for k, v in ins.items()},
                       {"activation": act})
    np.testing.assert_allclose(eager.numpy(), want, atol=5e-5, rtol=5e-5)
    np.testing.assert_allclose(_port_static(ins, act), want, atol=5e-5,
                               rtol=5e-5)
    # under composed_ops() the port takes the exact-gelu chain, which the
    # erf polynomial follows within 1.5e-7 per activation
    with F.composed_ops():
        np.testing.assert_allclose(_port_static(ins, act), want, atol=5e-5,
                                   rtol=5e-5)


def test_eager_op_is_differentiable():
    ins = {k: torch.from_numpy(v).requires_grad_()
           for k, v in _op_inputs(256, 128, 512).items()}
    y = tco.run_op("fused_ffn", ins, {"activation": "gelu"})
    gx, gw1 = torch.autograd.grad(y.sum(), [ins["X"], ins["W1"]])
    assert gx.shape == (256, 128) and gw1.shape == (128, 512)
    assert torch.isfinite(gx).all() and torch.isfinite(gw1).all()


def test_scope_from_numpy_keeps_names_and_types():
    sc = scope_from_numpy({"a": np.ones((2, 3), "float32"),
                           "b": np.arange(4, dtype="int32")}, CPUPlace())
    assert sc.find_var("a").dtype == torch.float32
    assert sc.find_var("b").dtype == torch.int32
    np.testing.assert_array_equal(sc.numpy("b"), np.arange(4))
    with scope_guard(sc):
        assert sc.has("a") and not sc.has("c")

"""The GPT train step of the port (paddle_tpu_torch/parallel/hybrid.py
over models/gpt.py, ops/flash_attention.py, ops/fused_block.py and
fluid/ops/optimizer_ops.py) against the JAX package's
HybridParallelTrainStep, gpt_loss and adamw op, on the same numpy
inputs and the same (bit-identical) initial weights. On the CPU the
port's kernels run their plain versions; the JAX flash kernels run in
interpret mode, as the JAX package's own tests run them."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.fluid import registry
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.parallel.hybrid import HybridParallelTrainStep as JStep
from paddle_tpu_torch.fluid.ops.optimizer_ops import adamw
from paddle_tpu_torch.models import gpt as pgpt
from paddle_tpu_torch.observability.perf import gpt_train_flops_per_step
from paddle_tpu_torch.parallel import HybridParallelTrainStep as PStep

SIZE = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
            max_position_embeddings=128, attn_impl="flash")
LR = 1e-4
STEPS = 3


def _ids(seed=0, batch=2, t=64):
    return np.random.RandomState(seed).randint(0, 512, (batch, t)) \
        .astype(np.int32)


def _flat(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v, np.float32)


def _run_port(amp=None, steps=STEPS, **kw):
    cfg = pgpt.GPTConfig(**{**SIZE, "amp_dtype": amp, **kw})
    step = PStep(cfg, device="cpu", lr=LR)
    ids = _ids()
    return [float(step(ids)) for _ in range(steps)], step


@pytest.fixture(scope="module")
def jax_f32():
    step = JStep(jgpt.GPTConfig(**SIZE), lr=LR)
    ids = _ids()
    losses = [float(step(ids)) for _ in range(STEPS)]
    return losses, dict(_flat(step.unstacked_params()))


def test_gpt_loss_matches_jax():
    cfg_p = pgpt.GPTConfig(**SIZE)
    tree = pgpt.init_gpt_params(cfg_p, seed=1)
    ids = _ids(seed=1)
    want = float(jgpt.gpt_loss(jax.tree_util.tree_map(jnp.asarray, tree),
                               jnp.asarray(ids), jgpt.GPTConfig(**SIZE)))
    params = {k: torch.from_numpy(v) for k, v in tree.items()
              if k != "blocks"}
    params["blocks"] = {k: torch.from_numpy(v)
                        for k, v in tree["blocks"].items()}
    got = float(pgpt.gpt_loss(params, torch.from_numpy(ids), cfg_p))
    assert abs(got - want) <= 1e-5 * abs(want)


def test_train_step_f32_matches_jax(jax_f32):
    """Loss curve within 1e-5 relative; parameters after 3 AdamW steps
    within 3 lr absolute (an Adam step is lr-sized, so a near-zero
    gradient whose sign flips on summation order moves an element by up
    to 2 lr) and 99.9% of elements within 1e-6."""
    want_losses, want_params = jax_f32
    losses, step = _run_port()
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5, atol=0)
    got = dict(_flat(step.unstacked_params()))
    assert got.keys() == want_params.keys()
    n_close = n_all = 0
    for name, w in want_params.items():
        g = got[name]
        assert g.shape == w.shape, name
        err = np.abs(g - w)
        assert err.max() <= 3 * LR, (name, err.max())
        n_close += int((err <= 1e-6).sum())
        n_all += err.size
    assert n_close >= 0.999 * n_all, n_close / n_all


def test_train_step_bf16_matches_jax():
    """bf16 amp_dtype: bf16 blocks round differently in the two packages
    (the Pallas flash kernel rounds P to bf16, the port keeps it f32),
    so the curves agree to bf16 precision, within 2e-2 relative."""
    jstep = JStep(jgpt.GPTConfig(**SIZE, amp_dtype="bfloat16"), lr=LR)
    ids = _ids()
    want = [float(jstep(ids)) for _ in range(STEPS)]
    got, _ = _run_port(amp="bfloat16")
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=0)


def test_remat_and_kernel_routes_give_the_same_losses():
    base, _ = _run_port(remat=True)
    no_remat, _ = _run_port(remat=False)
    composed, _ = _run_port(attn_impl="xla", fused_blocks=False)
    np.testing.assert_allclose(no_remat, base, rtol=1e-6, atol=0)
    np.testing.assert_allclose(composed, base, rtol=1e-5, atol=0)
    assert base[-1] < base[0]


def test_adamw_matches_the_jax_op():
    """Paddle's formula (eps outside the bias correction, decay before
    the step), in place, against the reference op on the same arrays."""
    rng = np.random.RandomState(3)
    p, g = rng.randn(2, 16, 8).astype(np.float32), \
        rng.randn(2, 16, 8).astype(np.float32)
    m1 = rng.randn(2, 16, 8).astype(np.float32) * 0.1
    m2 = np.abs(rng.randn(2, 16, 8)).astype(np.float32) * 0.01
    b1p, b2p = np.float32([0.9 ** 3]), np.float32([0.999 ** 3])
    opdef = registry.require("adamw")
    attrs = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, coeff=0.01)
    opdef.fill_default_attrs(attrs)
    outs = opdef.compute(None, {
        "Param": [jnp.asarray(p)], "Grad": [jnp.asarray(g)],
        "LearningRate": [jnp.asarray([1e-3], jnp.float32)],
        "Moment1": [jnp.asarray(m1)], "Moment2": [jnp.asarray(m2)],
        "Beta1Pow": [jnp.asarray(b1p)], "Beta2Pow": [jnp.asarray(b2p)]},
        attrs)
    tp, tm1, tm2 = (torch.from_numpy(a.copy()) for a in (p, m1, m2))
    nb1, nb2 = adamw(tp, torch.from_numpy(g), tm1, tm2,
                     torch.from_numpy(b1p), torch.from_numpy(b2p), 1e-3,
                     coeff=0.01)
    for got, key in ((tp, "ParamOut"), (tm1, "Moment1Out"),
                     (tm2, "Moment2Out"), (nb1, "Beta1PowOut"),
                     (nb2, "Beta2PowOut")):
        np.testing.assert_allclose(got.numpy(), np.asarray(outs[key][0]),
                                   rtol=1e-6, atol=1e-8, err_msg=key)


def test_lr_may_be_callable():
    cfg = pgpt.GPTConfig(**SIZE)
    calls = []

    def lr():
        calls.append(1)
        return LR

    step = PStep(cfg, device="cpu", lr=lr)
    step(_ids())
    assert calls == [1]


@pytest.mark.parametrize("kw,exc,match", [
    (dict(dp=2), ValueError, "world has 1"),
    (dict(pp=2), ValueError, "world has 1"),
    (dict(tp=2), ValueError, "world has 1"),
    (dict(sp=2), ValueError, "world has 1"),
    (dict(ep=2), ValueError, r"ep>1 needs a MoE model"),
    (dict(mesh=object()), TypeError, "Mesh")])
def test_mesh_axes_raise(kw, exc, match):
    """dp / pp / tp run over a world of their size
    (tests/test_torch_hybrid_parallel.py): outside one, the mesh raises
    (sp too); ep needs experts; a mesh is the port's Mesh."""
    with pytest.raises(exc, match=match):
        PStep(pgpt.GPTConfig(**SIZE), device="cpu", **kw)


def test_dropout_and_experts_raise():
    """Neither raises any more: the step trains at dropout 0.1 and
    returns a finite loss, and an expert model (4 experts) takes the
    reference's single-device losses over two steps within 5e-4."""
    step = PStep(pgpt.GPTConfig(**SIZE, dropout=0.1), device="cpu")
    assert np.isfinite(float(step(_ids())))
    step = PStep(pgpt.GPTConfig(**SIZE, num_experts=4), device="cpu",
                 lr=LR)
    jstep = JStep(jgpt.GPTConfig(**SIZE, num_experts=4), lr=LR)
    for _ in range(2):
        ids = _ids()
        assert abs(float(step(ids)) - float(jstep(ids))) < 5e-4


# -- residual dropout (the reference's jax.random masks cannot be
# replayed: the port's come from its counter-hash seed stream, held to
# its own composed chain with the same masks)

def _leaf_params(cfg, seed=1):
    tree = pgpt.init_gpt_params(cfg, seed=seed)
    params = {k: torch.from_numpy(v).requires_grad_() for k, v in
              tree.items() if k != "blocks"}
    params["blocks"] = {k: torch.from_numpy(v).requires_grad_()
                        for k, v in tree["blocks"].items()}
    leaves = [params[k] for k in ("wte", "wpe", "lnf_s", "lnf_b")] + \
        [params["blocks"][k] for k in sorted(params["blocks"])]
    return params, leaves


def test_dropout_zero_is_the_deterministic_path_bit_for_bit():
    cfg = pgpt.GPTConfig(**SIZE)
    params, leaves = _leaf_params(cfg)
    ids = torch.from_numpy(_ids(seed=4))
    plain = pgpt.gpt_loss(params, ids, cfg)
    keyed = pgpt.gpt_loss(params, ids, cfg, key=7)
    assert torch.equal(plain, keyed)
    for a, b in zip(torch.autograd.grad(plain, leaves),
                    torch.autograd.grad(keyed, leaves)):
        assert torch.equal(a, b)
    a, _ = _run_port(steps=2)
    b, _ = _run_port(steps=2, dropout=0.0)
    assert a == b


def test_dropout_keep_rate_and_masks_from_the_step_seed(monkeypatch):
    """Every residual mask (the embedding's and two a layer, five here)
    keeps 90% +- 2% of its elements; the same step seed gives the same
    seeds and loss bit for bit, the next step other seeds."""
    from paddle_tpu_torch.ops import fused_block, fused_residual
    seen = []
    real = fused_residual.keep_mask

    def spy(seed, rows, cols, p, device="cpu"):
        keep = real(seed, rows, cols, p, device)
        seen.append((seed, float(keep.float().mean())))
        return keep

    monkeypatch.setattr(fused_residual, "keep_mask", spy)
    cfg = pgpt.GPTConfig(**SIZE, dropout=0.1)
    params, _ = _leaf_params(cfg)
    ids = torch.from_numpy(_ids(seed=4))
    with torch.no_grad():
        a = pgpt.gpt_loss(params, ids, cfg, key=11)
        first = list(seen)
        seen.clear()
        b = pgpt.gpt_loss(params, ids, cfg, key=11)
        assert seen == first and torch.equal(a, b)
        seen.clear()
        c = pgpt.gpt_loss(params, ids, cfg, key=12)
    assert len(first) == 1 + 2 * SIZE["num_layers"]
    assert len({s for s, _ in first}) == len(first)
    assert not {s for s, _ in first} & {s for s, _ in seen}
    assert all(0.88 <= rate <= 0.92 for _, rate in first + seen), first
    assert float(c) != float(a)
    step = PStep(cfg, device="cpu", lr=0.0)
    l1, l2 = float(step(_ids())), float(step(_ids()))     # lr 0
    assert l1 != l2
    assert step.step_key(1) != step.step_key(2)
    with torch.no_grad():
        again = step.loss_fn(step.params, torch.from_numpy(_ids()).long(),
                             step.step_key(1))
    assert float(again) == l1


@pytest.mark.parametrize("remat", [True, False])
def test_dropout_kernels_match_the_composed_chain(remat):
    """The fused sub-blocks (their plain versions here) and flash
    against the composed tail and attention, same step seed: loss and
    every gradient, remat (masks replayed in the recompute) or not."""
    kw = dict(SIZE, dropout=0.1, remat=remat)
    fused = pgpt.GPTConfig(**kw)
    composed = pgpt.GPTConfig(**{**kw, "attn_impl": "xla"},
                              fused_blocks=False)
    ids = torch.from_numpy(_ids(seed=5))
    out = []
    for cfg in (fused, composed):
        params, leaves = _leaf_params(cfg)
        loss = pgpt.gpt_loss(params, ids, cfg, key=3)
        out.append((float(loss), torch.autograd.grad(loss, leaves)))
    (la, ga), (lb, gb) = out
    assert abs(la - lb) <= 1e-5 * abs(lb)
    gmax = max(float(g.abs().max()) for g in gb)
    for x, y in zip(ga, gb):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0,
                                   atol=1e-4 * gmax)


def test_no_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PStep(pgpt.GPTConfig(**SIZE))


def test_params_argument_and_unstacked_layout():
    cfg = pgpt.GPTConfig(**SIZE)
    tree = pgpt.init_gpt_params(cfg, seed=0)
    step = PStep(cfg, device="cpu", params=tree)
    got = step.unstacked_params()
    assert got["blocks"].keys() == tree["blocks"].keys()
    for (n, a), (_, b) in zip(_flat(got), _flat(tree)):
        np.testing.assert_array_equal(a, b, err_msg=n)


@pytest.mark.parametrize("layers,seq", [(24, 1024), (2, 64)])
def test_train_flops_match_bench(layers, seq):
    """The MFU numerator is bench.py's own count."""
    import bench
    cfg = pgpt.GPTConfig.gpt3_1p3b(num_layers=layers)
    assert gpt_train_flops_per_step(cfg, 2, seq) == \
        bench.gpt_train_flops_per_step(cfg, 2, seq)

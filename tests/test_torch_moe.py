"""Mixture-of-Experts (paddle_tpu_torch/parallel/moe.py) and the hybrid
GPT step with expert parallelism, each held to the JAX package: the
router and the expert FFN on the same numpy inputs in this process (the
cases of tests/test_moe.py), and GPT with 4 experts at dp2 x ep2 x tp2
and at ep2 x pp2 under 1F1B against the reference's mesh step at the
same combination (capacity and slots depend on the global batch and on
the microbatches, so the combination matters).

The port runs one gloo process a rank (tests/torch_hybrid_workers.py):
one world of 8 ranks and one of 4, each bounded by 60 s.

Tolerances: the router's outputs equal (0/1 and gates to 1e-6); the
FFN's output and gradients within 1e-5 (float32 sums in another order);
GPT losses within 5e-4 over 3 steps, parameters after them within
tests/test_torch_hybrid_parallel.py's PARAM; one step's gradients of
the router and the expert bank leaf by leaf within rtol 1e-4, atol 1e-6.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import gpt as JG
from paddle_tpu.parallel import moe as JM
from paddle_tpu.parallel.hybrid import HybridParallelTrainStep as JStep

import test_torch_hybrid_parallel as H
from paddle_tpu_torch.models.gpt import GPTConfig
from paddle_tpu_torch.parallel import HybridParallelTrainStep
from paddle_tpu_torch.parallel.moe import moe_capacity, moe_ffn, topk_gating

MOE = dict(num_experts=4)
DP_EP_TP = dict(dp=2, ep=2, tp=2)
EP_PP = dict(ep=2, pp=2, n_microbatches=2)
FLEET_EP = dict(expert_parallel=True,
                expert_parallel_configs={"ep_degree": 2},
                hybrid_configs={"dp_degree": 2, "pp_degree": 1,
                                "mp_degree": 2})
EXPERT_LEAVES = ["blocks.wg", "blocks.we_up", "blocks.be_up",
                 "blocks.we_down", "blocks.be_down", "blocks.bo"]


def _ids(seed=5, b=8, t=32):
    return np.random.RandomState(seed).randint(0, 512, (b, t)) \
        .astype(np.int32)


# -- the router and the expert FFN (one process) -----------------------------

@pytest.mark.parametrize("top_k,cf", [(1, 2.0), (1, 1.0), (2, 2.0),
                                      (2, 1.0)])
def test_gating_matches_the_reference(top_k, cf):
    """dispatch, combine and aux equal the reference's, with ample and
    with tight capacity (tokens dropped)."""
    rng = np.random.RandomState(top_k)
    N, E = 64, 4
    logits = rng.randn(N, E).astype(np.float32)
    C = moe_capacity(N, E, cf, top_k)
    assert C == JM.moe_capacity(N, E, cf, top_k)
    want = JM.topk_gating(jnp.asarray(logits), top_k, C)
    got = topk_gating(torch.from_numpy(logits), top_k, C)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-6)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-6)


def test_gating_dispatch_shapes_and_conservation():
    rng = np.random.RandomState(0)
    N, E, C = 64, 4, moe_capacity(64, 4, capacity_factor=2.0)
    logits = torch.from_numpy(rng.randn(N, E).astype(np.float32))
    dispatch, combine, aux = topk_gating(logits, top_k=1, capacity=C)
    assert dispatch.shape == (N, E, C) and combine.shape == (N, E, C)
    per_tok = dispatch.sum((1, 2)).numpy()
    assert per_tok.max() <= 1.0 + 1e-6
    assert per_tok.sum() == N      # capacity 2x: nothing dropped
    assert dispatch.sum(0).max() <= 1.0 + 1e-6   # no slot double-booked
    cw = combine.sum((1, 2)).numpy()
    np.testing.assert_allclose(cw[per_tok > 0], 1.0, atol=1e-5)
    assert np.isfinite(float(aux))


def test_gating_drops_overflow_tokens():
    logits = torch.tensor([[10.0, 0.0]]).repeat(32, 1)
    dispatch, _, _ = topk_gating(logits, top_k=1, capacity=8)
    assert float(dispatch.sum()) == 8.0


def test_top2_routes_to_two_experts():
    rng = np.random.RandomState(1)
    N, E = 16, 4
    logits = torch.from_numpy(rng.randn(N, E).astype(np.float32))
    C = moe_capacity(N, E, capacity_factor=2.0, top_k=2)
    dispatch, combine, _ = topk_gating(logits, top_k=2, capacity=C)
    assert (dispatch.sum((1, 2)).numpy() == 2).all()
    np.testing.assert_allclose(combine.sum((1, 2)).numpy(), 1.0, atol=1e-5)


def test_moe_ffn_single_expert_matches_dense():
    rng = np.random.RandomState(2)
    B, T, D, F = 2, 8, 16, 32
    x = torch.from_numpy(rng.randn(B, T, D).astype(np.float32))
    wg = torch.zeros(D, 1)
    wu = torch.from_numpy(rng.randn(1, D, F).astype(np.float32) * 0.1)
    bu = torch.zeros(1, F)
    wd = torch.from_numpy(rng.randn(1, F, D).astype(np.float32) * 0.1)
    bd = torch.zeros(1, D)
    y, aux = moe_ffn(x, wg, wu, bu, wd, bd, capacity_factor=2.0)
    ref = jax.nn.gelu(jnp.asarray(x.numpy()) @ jnp.asarray(wu[0].numpy()),
                      approximate=True) @ jnp.asarray(wd[0].numpy())
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(float(aux), 1.0, atol=1e-5)


@pytest.mark.parametrize("top_k,cf", [(1, 2.0), (1, 1.0), (2, 1.0)])
def test_moe_ffn_value_and_gradients_match_the_reference(top_k, cf):
    """y, aux and the gradients of x and of every weight (the router's
    through the kept gates and the aux) equal the reference's."""
    rng = np.random.RandomState(3)
    B, T, D, F, E = 2, 16, 8, 16, 4
    x = rng.randn(B, T, D).astype(np.float32)
    ws = [rng.randn(D, E).astype(np.float32) * 0.5,
          rng.randn(E, D, F).astype(np.float32) * 0.1,
          rng.randn(E, F).astype(np.float32) * 0.1,
          rng.randn(E, F, D).astype(np.float32) * 0.1,
          rng.randn(E, D).astype(np.float32) * 0.1]

    def jloss(x, *w):
        y, aux = JM.moe_ffn(x, *w, capacity_factor=cf, top_k=top_k)
        return jnp.mean(y * y) + 0.01 * aux, (y, aux)

    (_, (jy, jaux)), jg = jax.value_and_grad(
        jloss, argnums=tuple(range(6)), has_aux=True)(
            jnp.asarray(x), *map(jnp.asarray, ws))
    xt = torch.from_numpy(x).requires_grad_()
    wt = [torch.from_numpy(w).requires_grad_() for w in ws]
    y, aux = moe_ffn(xt, *wt, capacity_factor=cf, top_k=top_k)
    grads = torch.autograd.grad(torch.mean(y * y) + 0.01 * aux, [xt] + wt)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               atol=1e-5)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5)
    for i, (g, w) in enumerate(zip(grads, jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   err_msg=str(i))
    assert float(grads[1].abs().max()) > 0    # the router learns


def test_init_and_specs_match_the_reference():
    """The expert bank's init is the reference's bit for bit (the same
    draws in the same order) and its specs are the reference's."""
    from paddle_tpu.models.gpt import gpt_param_specs as jspecs
    from paddle_tpu_torch.models.gpt import (gpt_param_specs,
                                             init_gpt_params, param_shapes)
    cfg = GPTConfig.tiny(**MOE)
    got = init_gpt_params(cfg, 0)
    want = JG.init_gpt_params(JG.GPTConfig.tiny(**MOE), 0)
    assert list(got["blocks"]) == list(want["blocks"])
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    assert param_shapes(cfg)["blocks"] == {
        k: v.shape for k, v in got["blocks"].items()}
    for stacked in (False, True):
        ref = jspecs(pp_stacked=stacked, moe=True)
        port = gpt_param_specs(stacked, moe=True)
        for k, v in ref["blocks"].items():
            assert tuple(v) == port["blocks"][k], k


def test_ep_and_moe_validation_errors():
    """The reference's checks and exception types, before any rank is
    asked for."""
    with pytest.raises(ValueError, match="num_experts"):
        HybridParallelTrainStep(GPTConfig.tiny(), dp=4, ep=2, device="cpu")
    with pytest.raises(ValueError, match="num_experts"):
        JStep(JG.GPTConfig.tiny(), dp=4, ep=2)
    with pytest.raises(ValueError, match="not divisible by ep=3"):
        HybridParallelTrainStep(GPTConfig.tiny(**MOE), ep=3, device="cpu")
    with pytest.raises(NotImplementedError, match="1F1B"):
        HybridParallelTrainStep(GPTConfig.tiny(**MOE), pp=2,
                                pipeline_schedule="F-then-B", device="cpu")


# -- GPT with experts over ranks --------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    ids = _ids()
    cases = [
        ("dp_ep_tp", "hybrid", (DP_EP_TP, MOE, ids, 3)),
        ("grads", "hybrid_grads", (DP_EP_TP, MOE, ids, EXPERT_LEAVES)),
        ("fleet", "fleet_hybrid", (FLEET_EP, _ids(seed=6), MOE)),
    ]
    return H._world(tmp_path_factory.mktemp("moe_world"), 8, cases)


@pytest.fixture(scope="module")
def world_pp(tmp_path_factory):
    cases = [("ep_pp", "hybrid", (EP_PP, MOE, _ids(), 3))]
    return H._world(tmp_path_factory.mktemp("moe_pp_world"), 4, cases)


def _reference(**kw):
    s = JStep(JG.GPTConfig.tiny(**MOE), seed=0, **kw)
    ids = _ids()
    losses = [float(s(ids)) for _ in range(3)]
    return losses, jax.tree_util.tree_map(np.asarray, s.unstacked_params())


def test_gpt_moe_dp2_ep2_tp2_matches_the_reference(world):
    """Losses and parameters of the reference's dp2 x ep2 x tp2 step on
    every rank; it trains; each rank holds E/ep experts and F/tp of
    each (1/(ep tp) of the bank)."""
    want, wparams = _reference(**DP_EP_TP)
    L, E, D, F = 4, 4, 64, 256
    for res in world:
        got = res["dp_ep_tp"]
        H._check_losses(got["losses"], want)
        assert got["losses"][-1] < got["losses"][0]
        H._check_params(got["params"], wparams)
        c = got["coords"]
        we_up = got["local"]["blocks.we_up"]
        assert we_up.shape == (L, E // 2, D, F // 2)
        np.testing.assert_allclose(
            we_up, wparams["blocks"]["we_up"][
                :, c["ep"] * 2:(c["ep"] + 1) * 2, :,
                c["tp"] * 128:(c["tp"] + 1) * 128], **H.PARAM)
        assert got["local"]["blocks.wg"].shape == (L, D, E)


def test_gpt_moe_ep2_pp2_1f1b_threads_the_aux(world_pp):
    """ep2 x pp2 under 1F1B, 2 microbatches: each stage adds its layers'
    aux with the microbatch's cotangent, as the reference's engine."""
    want, wparams = _reference(**EP_PP)
    for res in world_pp:
        H._check_losses(res["ep_pp"]["losses"], want)
        H._check_params(res["ep_pp"]["params"], wparams)


def test_router_and_expert_gradients_leaf_by_leaf(world):
    """One step's reduced gradients at dp2 x ep2 x tp2 against the
    reference's gradient of the same loss: the replicated router's (wg)
    counted once, not ep x tp times; each rank's expert pieces (not
    summed over ep; an expert block's biases not summed over tp); and
    the global norm the clip divides by, each leaf counted once (expert
    pieces summed over ep and tp)."""
    cfg = JG.GPTConfig.tiny(**MOE)
    params = jax.tree_util.tree_map(jnp.asarray,
                                    JG.init_gpt_params(cfg, 0))
    ids = jnp.asarray(_ids())
    loss, g = jax.value_and_grad(lambda p: JG.gpt_loss(p, ids, cfg))(params)
    norm = float(jnp.sqrt(sum(jnp.sum(jnp.square(x))
                              for x in jax.tree_util.tree_leaves(g))))
    tol = dict(rtol=1e-4, atol=1e-6)
    for res in world:
        got = res["grads"]
        assert abs(got["loss"] - float(loss)) < 1e-5
        assert abs(got["norm"] - norm) < 1e-5 * norm, (got["norm"], norm)
        c = got["coords"]
        e, t = slice(c["ep"] * 2, c["ep"] * 2 + 2), c["tp"]
        f = slice(t * 128, (t + 1) * 128)
        want = {"blocks.wg": g["blocks"]["wg"],
                "blocks.bo": g["blocks"]["bo"],
                "blocks.we_up": g["blocks"]["we_up"][:, e, :, f],
                "blocks.be_up": g["blocks"]["be_up"][:, e, f],
                "blocks.we_down": g["blocks"]["we_down"][:, e, f],
                "blocks.be_down": g["blocks"]["be_down"][:, e]}
        for n, w in want.items():
            np.testing.assert_allclose(got["grads"][n], np.asarray(w),
                                       err_msg=n, **tol)


def test_fleet_strategy_consumes_expert_parallel(world):
    for res in world:
        got = res["fleet"]
        assert got["ep"] == 2 and got["shape"]["ep"] == 2
        assert got["shape"]["tp"] == 2 and got["shape"]["dp"] == 2
        assert np.isfinite(got["loss"])

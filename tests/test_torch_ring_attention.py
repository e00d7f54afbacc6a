"""Ring attention over the sp axis (paddle_tpu_torch/parallel/
sequence_parallel.py) and the hybrid GPT step with sp > 1, each held to
the JAX package at the same combination: the reference's ring on its 8
virtual CPU devices, its HybridParallelTrainStep at dp2 x sp4 and at
dp2 x pp2 x sp2 under 1F1B (the cases of tests/test_ring_attention.py
and test_hybrid_parallel.py::test_sp_x_pp_matches_single_device).

The port runs one gloo process a rank (tests/torch_hybrid_workers.py);
one world of 8 ranks serves every case, bounded by 60 s.

Tolerances: the ring's loss within 1e-5 relative and its q/k/v
gradients within atol 2e-4 / rtol 1e-3 (the reference test's); GPT
losses within 5e-4 over 3 steps and the parameters after them leaf by
leaf within tests/test_torch_hybrid_parallel.py's PARAM.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P

from paddle_tpu.models.gpt import GPTConfig as JConfig
from paddle_tpu.parallel.hybrid import HybridParallelTrainStep as JStep
from paddle_tpu.parallel.sequence_parallel import _dense as jdense
from paddle_tpu.parallel.sequence_parallel import ring_attention as jring

import test_torch_hybrid_parallel as H
import torch_hybrid_workers as W
from paddle_tpu_torch.models.gpt import GPTConfig
from paddle_tpu_torch.parallel import HybridParallelTrainStep

SP_PP = dict(dp=2, pp=2, sp=2, n_microbatches=2, pipeline_schedule="1F1B")
FLEET_SP = dict(sequence_parallel=True,
                sequence_parallel_configs={"sp_degree": 4},
                hybrid_configs={"dp_degree": 2})


def _ids(b, t, seed=0):
    return np.random.RandomState(seed).randint(0, 512, (b, t)) \
        .astype(np.int32)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases = [
        ("ring_causal", "ring", ({"dp": 2, "sp": 4}, True, 256)),
        ("ring_full", "ring", ({"dp": 2, "sp": 4}, False, 256)),
        ("ring_sp8", "ring", ({"sp": 8}, True, 512)),
        ("dp2sp4", "hybrid", (dict(dp=2, sp=4), {}, _ids(4, 128), 3)),
        ("sp_pp", "hybrid", (SP_PP, {}, _ids(8, 64), 3)),
        ("dropout", "hybrid", (dict(dp=2, sp=4), dict(dropout=0.1),
                               _ids(4, 128), 2, False)),
        ("fleet", "fleet_hybrid", (FLEET_SP, _ids(4, 64, seed=1))),
    ]
    return H._world(tmp_path_factory.mktemp("ring_world"), 8, cases)


def _reference_ring(causal, S=256):
    """The reference's ring on its (dp 2, sp 4) mesh: loss, q/k/v
    gradients; and the dense function's loss."""
    mesh = JMesh(np.array(jax.devices()).reshape(2, 4), ("dp", "sp"))
    q, k, v = (jnp.asarray(a) for a in W.qkv(S=S))
    spec = NamedSharding(mesh, P(None, None, "sp", None))
    qs, ks, vs = (jax.device_put(t, spec) for t in (q, k, v))

    def loss_ring(q, k, v):
        return jnp.sum(jring(q, k, v, mesh, "sp", causal=causal) ** 2)

    l1, g1 = jax.jit(jax.value_and_grad(loss_ring, argnums=(0, 1, 2)))(
        qs, ks, vs)
    l2 = float(jnp.sum(jdense(q, k, v, causal, 0.25) ** 2))
    return float(l1), [np.asarray(g) for g in g1], l2


@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_dense(world, causal):
    """The port's ring on dp 2 x sp 4 ranks: the loss (the sp shares
    summed) within 1e-5 of the dense function's and the reference
    ring's, and the q/k/v gradients (the shards put together) the
    reference ring's, on both dp rows."""
    want, wgrads, dense = _reference_ring(causal)
    assert abs(want - dense) / abs(dense) < 1e-5
    name = "ring_causal" if causal else "ring_full"
    for row in (world[:4], world[4:]):
        got = sum(r[name]["loss"] for r in row)
        assert abs(got - dense) / abs(dense) < 1e-5, (got, dense)
        assert [r[name]["sp"] for r in row] == [0, 1, 2, 3]
        for i, w in enumerate(wgrads):
            g = np.concatenate([r[name]["grads"][i] for r in row], axis=2)
            np.testing.assert_allclose(g, w, atol=2e-4, rtol=1e-3,
                                       err_msg="qkv"[i])


def test_ring_output_stays_sequence_sharded(world):
    """At sp 8 each rank holds only its [B, H, S/8, D] shard of the
    output, and the shards are dense causal attention's."""
    q, k, v = (jnp.asarray(a) for a in W.qkv(S=512))
    dense = np.asarray(jdense(q, k, v, True, 0.25))
    for r, res in enumerate(world):
        out = res["ring_sp8"]["out"]
        assert res["ring_sp8"]["sp"] == r
        assert out.shape == (2, 2, 64, 16)
        np.testing.assert_allclose(out, dense[:, :, r * 64:(r + 1) * 64],
                                   atol=2e-5, rtol=1e-4)


def _reference_gpt(ids, **kw):
    s = JStep(JConfig.tiny(), seed=0, **kw)
    losses = [float(s(ids)) for _ in range(3)]
    return s, losses, jax.tree_util.tree_map(np.asarray,
                                             s.unstacked_params())


@pytest.mark.parametrize("case,kw,ids", [
    ("dp2sp4", dict(dp=2, sp=4), _ids(4, 128)),
    ("sp_pp", SP_PP, _ids(8, 64)),
])
def test_gpt_sequence_parallel_matches_the_reference(world, case, kw, ids):
    """GPT at dp2 x sp4 and at dp2 x pp2 x sp2 (1F1B): the losses of 3
    steps and the parameters after them are the reference mesh step's,
    on every rank, and the loss falls."""
    s, want, wparams = _reference_gpt(ids, **kw)
    assert s.cfg.attn_impl == "ring"
    for res in world:
        got = res[case]
        H._check_losses(got["losses"], want)
        assert got["losses"][-1] < got["losses"][0]
        H._check_params(got["params"], wparams)


def test_sp_step_takes_ring_attention_and_refuses_gpipe():
    """At sp > 1 the step's config carries attn_impl "ring" (checked on
    the ranks by the fleet case); sp x pp under F-then-B raises the
    reference's NotImplementedError naming 1F1B, and a sequence sp does
    not divide raises on the call (a mesh of one rank)."""
    with pytest.raises(NotImplementedError, match="1F1B"):
        HybridParallelTrainStep(GPTConfig.tiny(), pp=2, sp=2,
                                n_microbatches=4,
                                pipeline_schedule="F-then-B", device="cpu")
    with pytest.raises(NotImplementedError, match="1F1B"):
        JStep(JConfig.tiny(), dp=1, pp=2, sp=2, n_microbatches=4,
              pipeline_schedule="F-then-B")


def test_sp_dropout_is_finite_and_equal_on_every_rank(world):
    base = world[0]["dropout"]["losses"]
    assert np.isfinite(base).all()
    assert base != world[0]["dp2sp4"]["losses"][:2]
    for res in world:
        assert res["dropout"]["losses"] == base


def test_fleet_strategy_consumes_sequence_parallel(world):
    for res in world:
        got = res["fleet"]
        assert got["sp"] == 4 and got["shape"]["sp"] == 4
        assert got["shape"]["dp"] == 2
        assert got["attn_impl"] == "ring"
        assert np.isfinite(got["loss"])

"""The row-sharded embedding (paddle_tpu_torch/parallel/embedding.py) and
wide&deep over a dp x mp mesh, held to the JAX package at the same
combination (tests/test_sparse_embedding.py's
``test_sharded_lookup_matches_dense_take`` and
``test_widedeep_trains_and_matches_single_device``): the reference's
lookup and its WideDeepTrainStep at dp2 x mp4 on the 8 virtual CPU
devices.

The port runs one gloo process a rank (tests/torch_hybrid_workers.py);
one world of 8 ranks (dp 2 x mp 4) serves both, bounded by 60 s.

Tolerances: the lookup's loss within 1e-3 and the table's gradient
within 1e-5 (the reference test's); wide&deep losses within 5e-4 of the
reference's over 5 steps (its test's bound) and the gathered
parameters within 1e-5 relative (+1e-6), as tests/test_torch_widedeep.py
holds the single device.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P

from paddle_tpu.models.wide_deep import WideDeepConfig as JConfig
from paddle_tpu.models.wide_deep import WideDeepTrainStep as JStep
from paddle_tpu.parallel.embedding import sharded_embedding_lookup as jlookup

import test_torch_hybrid_parallel as H
import test_torch_widedeep as WD
from paddle_tpu_torch.models.wide_deep import WideDeepConfig

AXES = {"dp": 2, "mp": 4}


def _batches(n=5):
    """The reference test's batches: the label is one slot's parity."""
    cfg = JConfig.tiny()
    out = []
    for i in range(n):
        r = np.random.RandomState(100 + i)
        ids = r.randint(0, cfg.vocab_size, (16, cfg.num_slots))
        dense = r.randn(16, cfg.dense_dim).astype(np.float32)
        label = (ids[:, 0] % 2).astype(np.float32)[:, None]
        out.append((ids, dense, label))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases = [
        ("lookup", "lookup", (AXES, 64, 8, (16, 5))),
        ("widedeep", "widedeep", (dict(dp=2, mp=4), _batches())),
    ]
    return H._world(tmp_path_factory.mktemp("embedding_world"), 8, cases)


def test_sharded_lookup_matches_dense_take(world):
    """Every rank's embeddings are the dense take's; the loss is
    sum(out ** 2) of the dense take; each mp rank's table gradient is
    its rows of the reference's (the scatter-add of its hits)."""
    mesh = JMesh(np.array(jax.devices()).reshape(2, 4), ("dp", "mp"))
    rng = np.random.RandomState(0)
    table = jnp.asarray(rng.randn(64, 8).astype(np.float32))
    ids = jnp.asarray(rng.randint(0, 64, (16, 5)))
    tsh = jax.device_put(table, NamedSharding(mesh, P("mp", None)))

    def loss_sh(t, i):
        return jnp.sum(jlookup(t, i, mesh, "mp") ** 2)

    want, wgrad = jax.jit(jax.value_and_grad(loss_sh))(tsh, ids)
    dense = np.asarray(jnp.take(table, ids, axis=0))
    wgrad = np.asarray(wgrad)
    for res in world:
        got = res["lookup"]
        i = got["mp"]
        np.testing.assert_allclose(got["out"], dense, atol=1e-6)
        assert abs(got["loss"] - float(want)) < 1e-3
        np.testing.assert_allclose(got["grad"], wgrad[i * 16:(i + 1) * 16],
                                   atol=1e-5)
        assert "vocab 63 not divisible by mp=4" in got["error"]


def test_sharded_embedding_module_takes_its_rows_of_the_reference_init(
        world):
    from paddle_tpu.parallel.embedding import ShardedEmbedding
    mesh = JMesh(np.array(jax.devices()).reshape(2, 4), ("dp", "mp"))
    ref = ShardedEmbedding(64, 8, mesh, seed=3)
    full = np.asarray(ref.table)
    for res in world:
        got = res["lookup"]
        i = got["mp"]
        np.testing.assert_array_equal(got["module_table"],
                                      full[i * 16:(i + 1) * 16])
        assert got["module_out"].shape == (16, 5, 8)


def test_widedeep_dp2_mp4_matches_the_reference(world):
    """5 Adam steps at dp2 x mp4: the losses are the reference mesh
    step's within 5e-4 and fall below ln 2; each rank holds 1/4 of each
    table's rows (and of their moments); the gathered tree is the
    reference's."""
    s8 = JStep(JConfig.tiny(), dp=2, mp=4, seed=0)
    want = [float(s8(*b)) for b in _batches()]
    wparams = WD._named(s8.params)
    V = WideDeepConfig.tiny().vocab_size
    for res in world:
        got = res["widedeep"]
        for i, (a, b) in enumerate(zip(got["losses"], want)):
            assert abs(a - b) < 5e-4, f"step {i}: {a} vs {b}"
        assert got["losses"][-1] < float(np.log(2))
        assert got["local"] == {"embed": (V // 4, 8), "wide": (V // 4, 1)}
        assert got["moments"] == (V // 4, 8)
        gp = WD._named(got["params"])
        assert list(gp) == list(wparams)
        for k, w in wparams.items():
            np.testing.assert_allclose(gp[k], w, rtol=1e-5, atol=1e-6,
                                       err_msg=k)

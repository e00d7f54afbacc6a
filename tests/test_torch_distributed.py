"""The port's collectives, process groups and worker spawning
(paddle_tpu_torch/distributed/) on two gloo processes on the CPU,
against numpy: every ReduceOp of all_reduce, all_gather, broadcast,
reduce (only dst changes), scatter, barrier, split, the c_* ops inside a
static program run data-parallel, and the bucketed gradient all-reduce;
identities at a world of one; the env, mesh and backend rules; a failing
or hanging rank. The workers (tests/torch_dp_workers.py) import torch
and the port only; every spawn is bounded by a 60 s timeout."""
import os
import pickle

import numpy as np
import pytest
import torch

import torch_dp_workers as W
from paddle_tpu_torch.distributed import (collective, env, mesh, parallel,
                                          spawn)
from paddle_tpu_torch.distributed.spawn import get_cluster_env

TIMEOUT = 60


def _spawn(tmp_path, case, *args, nprocs=2):
    spawn(W.run, args=(case, str(tmp_path), *args), nprocs=nprocs,
                timeout=TIMEOUT)
    out = []
    for r in range(nprocs):
        with open(os.path.join(tmp_path, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("collectives"), "collectives")


def _base(r):
    return np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r


@pytest.mark.parametrize("op,fn", [("sum", np.add), ("max", np.maximum),
                                   ("min", np.minimum),
                                   ("prod", np.multiply)])
def test_all_reduce_every_op(two_ranks, op, fn):
    want = fn(_base(0) + 1, _base(1) + 1)
    for res in two_ranks:
        np.testing.assert_array_equal(res[f"all_reduce_{op}"], want)


def test_gather_broadcast_reduce_scatter_split(two_ranks):
    for r, res in enumerate(two_ranks):
        assert res["rank"] == r and res["world"] == 2
        assert res["backend"] == "gloo"
        assert res["penv"][:3] == (r, 2, r) and len(res["penv"][3]) == 2
        np.testing.assert_array_equal(np.stack(res["all_gather"]),
                                      np.stack([_base(0), _base(1)]))
        np.testing.assert_array_equal(res["broadcast"], _base(1))
        # reduce: the sum only on dst = 1, rank 0 keeps its input
        np.testing.assert_array_equal(
            res["reduce"], _base(0) + _base(1) if r == 1 else _base(0))
        np.testing.assert_array_equal(res["scatter"],
                                      np.full(3, 7.0 + r, np.float32))
        np.testing.assert_array_equal(np.concatenate(res["split"], 1),
                                      _base(r))


def test_bucketed_all_reduce_boundaries_and_values(two_ranks):
    """A 1 KiB budget over f32 (256 B), f32 (800 B), f64 (64 B), f32
    (64 B): the second tensor would overflow the first bucket, the f64
    one changes dtype, the last changes it back. Sums scaled by 0.5."""
    for res in two_ranks:
        assert res["buckets"] == [[0], [1], [2], [3]]
        for i, t in enumerate(res["bucketed"]):
            np.testing.assert_array_equal(t, np.full_like(t, 1.5 + i))


def test_bucket_indices_by_size_and_dtype():
    f, d = torch.float32, torch.float64
    ts = [torch.zeros(4, dtype=f), torch.zeros(4, dtype=f),
          torch.zeros(2, dtype=d), torch.zeros(2, dtype=d),
          torch.zeros(100, dtype=f), torch.zeros(1, dtype=f)]
    assert parallel.bucket_indices(ts, 64) == [[0, 1], [2, 3], [4], [5]]
    assert parallel.bucket_indices(ts, 1 << 20) == [[0, 1], [2, 3], [4, 5]]
    assert parallel.bucket_indices([], 64) == []


def test_c_ops_in_a_data_parallel_program(two_ranks):
    x = W.C_OPS_X
    a, b = x[:2], x[2:]
    for r, res in enumerate(two_ranks):
        c, mine = res["c_ops"], (a, b)[r]
        np.testing.assert_allclose(c["c_allreduce_sum"], a + b, rtol=1e-6)
        np.testing.assert_array_equal(c["c_allreduce_max"], np.maximum(a, b))
        np.testing.assert_array_equal(c["c_allreduce_min"], np.minimum(a, b))
        np.testing.assert_array_equal(c["c_allgather"], x)
        np.testing.assert_array_equal(c["c_broadcast"], b)
        np.testing.assert_allclose(c["c_reducescatter"], (a + b)[r:r + 1],
                                   rtol=1e-6)
        np.testing.assert_array_equal(c["c_concat"],
                                      np.concatenate([a, b], -1))
        np.testing.assert_array_equal(c["c_identity"], mine)
        np.testing.assert_array_equal(c["c_split"],
                                      mine[:, 3 * r:3 * r + 3])
        np.testing.assert_array_equal(c["c_sync_calc_stream"], mine)


def test_a_world_of_one_is_the_identity(tmp_path):
    """Without a process group every collective and c_* op is the
    identity, in this process and in a spawn of one (run inline)."""
    t = torch.arange(4.0)
    assert collective.all_reduce(t, collective.ReduceOp.MAX) is t
    parts = []
    collective.all_gather(parts, t)
    assert len(parts) == 1 and parts[0] is t
    assert collective.broadcast(t, 0) is t and collective.reduce(t) is t
    dst = torch.zeros(4)
    collective.scatter(dst, [t])
    assert torch.equal(dst, t)
    collective.barrier()
    assert collective.batch_group() is None
    with collective.collective_axis("dp"):
        assert collective.batch_total(t)[1] == 1
    assert env.get_rank() == 0 and env.get_world_size() == 1
    m = mesh.make_mesh()
    assert m.shape == {"dp": 1} and m.group("dp") is None
    out = _spawn(tmp_path, "world_of_one", nprocs=1)[0]
    np.testing.assert_array_equal(out["t"], np.ones(3))
    assert out["n_parts"] == 1


def test_backend_and_device_rules(monkeypatch):
    assert env.backend_for(2, 1) == "gloo"      # two ranks share a card
    assert env.backend_for(2, 0) == "gloo"      # no card
    assert env.backend_for(4, 4) == "nccl"      # a card each
    assert env.backend_for(1, 8) == "nccl"
    monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS",
                       "10.0.0.1:1,10.0.0.1:2,10.0.0.2:1")
    monkeypatch.setenv("PADDLE_CURRENT_ENDPOINT", "10.0.0.1:2")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    assert env._local() == (1, 2)
    assert env.ParallelEnv().local_rank == 1
    assert env.rank_device(1).type in ("cpu", "cuda")
    with pytest.raises(ValueError, match="at most one"):
        mesh.make_mesh({"dp": -1, "tp": -1})
    with pytest.raises(ValueError, match="world has 1"):
        mesh.make_mesh({"dp": 2})


def test_cluster_env_matches_the_reference_launcher():
    from paddle_tpu.distributed.launch import get_cluster_env as ref
    eps = ["127.0.0.1:7001", "127.0.0.1:7002"]
    for r in range(2):
        assert get_cluster_env(r, eps) == ref(r, eps)
    assert get_cluster_env(0, eps, "PSERVER", "a:1", "b:2") == \
        ref(0, eps, "PSERVER", "a:1", "b:2")


def test_a_failed_rank_fails_the_spawn(tmp_path):
    with pytest.raises(RuntimeError, match=r"\(1, 1\)"):
        spawn(W.run, args=("fail_on_rank_one", str(tmp_path)),
                    nprocs=2, timeout=TIMEOUT)


def test_a_hung_rank_fails_the_spawn_at_its_timeout(tmp_path):
    with pytest.raises(RuntimeError, match="timeout"):
        spawn(W.run, args=("hang", str(tmp_path)), nprocs=2,
                    timeout=8)


def test_distributed_exports_the_references_names():
    import paddle_tpu.distributed as ref
    import paddle_tpu_torch.distributed as port
    assert set(port.__all__) == set(ref.__all__)
    for name in port.__all__:
        assert getattr(port, name) is not None, name
    assert callable(port.spawn)


def test_fleet_collective_mode_surface(monkeypatch):
    """At a world of one: the strategy bag equals the reference's; with
    no meta-optimizer enabled the user's optimizer passes through, an
    enabled one raises naming its item; the parameter-server methods
    run the PS runtime (a world with no server endpoints gets a client of
    no shards and no shard to bind, as the reference's), the savers
    raise naming item 12; hybrid_train_step builds
    the GPT step at dp = pp = tp = 1 and raises for dp = 2 (item
    14(b))."""
    import numpy as np
    from paddle_tpu.distributed.fleet import DistributedStrategy as JStrategy
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import \
        apply_meta_optimizers
    from paddle_tpu_torch.models.gpt import GPTConfig
    for name in ("PADDLE_TRAINER_ENDPOINTS", "PADDLE_TRAINER_ID",
                 "PADDLE_TRAINERS_NUM", "PADDLE_COORDINATOR"):
        monkeypatch.delenv(name, raising=False)
    st = fleet.DistributedStrategy()
    assert st.to_dict() == JStrategy().to_dict()
    opt = object()
    assert apply_meta_optimizers(opt, st) is opt
    st.amp = True
    with pytest.raises(NotImplementedError, match=r"amp \(ROADMAP.md A, "
                                                  r"item 13\)"):
        apply_meta_optimizers(opt, st)
    st.amp, st.gradient_merge = False, True
    with pytest.raises(NotImplementedError, match=r"gradient_merge "
                                                  r"\(ROADMAP.md A, item 12\)"):
        apply_meta_optimizers(opt, st)
    st.gradient_merge = False
    st.amp, st.recompute = False, True
    with pytest.raises(NotImplementedError, match="item 12"):
        apply_meta_optimizers(opt, st)
    fleet.init(is_collective=True)
    assert (fleet.worker_num(), fleet.worker_index(),
            fleet.is_first_worker(), fleet.is_worker()) == (1, 0, True, True)
    fleet.barrier_worker()
    assert fleet.init_worker().endpoints == []
    fleet.stop_worker()
    for call in (fleet.init_server, fleet.run_server):
        with pytest.raises(IndexError):
            call()
    f = fleet.Fleet()
    with pytest.raises(NotImplementedError, match="item 12"):
        f.save_persistables(None, "x")
    step = fleet.hybrid_train_step(GPTConfig.tiny(), device="cpu")
    ids = np.random.RandomState(0).randint(0, 512, (2, 64))
    assert np.isfinite(float(step(ids)))
    # the hybrid step runs dp / pp / tp over a world of their size
    # (tests/test_torch_hybrid_parallel.py): outside one the mesh raises,
    # sequence parallelism's too
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": 2}
    fleet.init(is_collective=True, strategy=st)
    with pytest.raises(ValueError, match="world has 1"):
        fleet.hybrid_train_step(GPTConfig.tiny(), device="cpu")
    st.hybrid_configs = {"dp_degree": 1, "sp_degree": 2}
    with pytest.raises(ValueError, match="world has 1"):
        fleet.hybrid_train_step(GPTConfig.tiny(), device="cpu")
    fleet.init(is_collective=True)      # the default strategy again

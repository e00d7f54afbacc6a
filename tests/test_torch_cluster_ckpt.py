"""Coordinated cluster checkpoints and the sample schedule of the port
(paddle_tpu_torch/distributed/cluster_ckpt.py) on the CPU, held to the
JAX package:

  * the in-process cases of tests/test_elastic_training.py (schedule,
    roundtrips at the same world and after 4 -> 2, uncommitted parts,
    async, the intent-file cadence, a plain manifest refused);
  * ``SampleSchedule`` equal to the reference's bit for bit over seeds,
    epochs, sizes and worlds, guards included;
  * cluster checkpoints across the packages in both directions, at
    world 2 -> 2 and 4 -> 2, with bit-equal arrays, and uncommitted
    parts invisible to both;
  * torch tensors saved directly (bfloat16 refused, as in the store).
"""
import os
import time

import numpy as np
import pytest
import torch

from paddle_tpu.distributed import cluster_ckpt as jcc
from paddle_tpu_torch.checkpoint import CheckpointStore
from paddle_tpu_torch.checkpoint import manifest as manifest_mod
from paddle_tpu_torch.distributed import cluster_ckpt as pcc
from paddle_tpu_torch.distributed.cluster_ckpt import (
    ClusterCheckpoint, ClusterCheckpointError, SampleSchedule)
from paddle_tpu_torch.observability.registry import REGISTRY

PKGS = {"port": pcc, "ref": jcc}


# ---------------------------------------------------------------------------
# sample schedule
# ---------------------------------------------------------------------------

def test_sample_schedule_world_invariant_partition():
    s = SampleSchedule(seed=7, epoch=0, num_samples=64, global_batch=8)
    for step in (0, 3, 7):
        g = s.global_indices(step)
        assert len(g) == 8
        for world in (1, 2, 4, 8):
            parts = [s.rank_indices(step, r, world)
                     for r in range(world)]
            np.testing.assert_array_equal(np.concatenate(parts), g)
    s2 = SampleSchedule(seed=7, epoch=0, num_samples=64, global_batch=8)
    np.testing.assert_array_equal(s.perm, s2.perm)
    assert not np.array_equal(
        s.perm, SampleSchedule(seed=7, epoch=1, num_samples=64,
                               global_batch=8).perm)


def test_sample_schedule_remaining_and_guards():
    s = SampleSchedule(seed=1, epoch=0, num_samples=40, global_batch=10)
    np.testing.assert_array_equal(s.remaining(next_step=2), s.perm[20:40])
    np.testing.assert_array_equal(s.global_indices(4),
                                  s.global_indices(0))
    with pytest.raises(ValueError, match="divisible"):
        s.rank_indices(0, 0, 3)
    with pytest.raises(ValueError):
        s.rank_indices(0, 5, 2)
    with pytest.raises(ValueError):
        SampleSchedule(seed=0, epoch=0, num_samples=4, global_batch=8)


@pytest.mark.parametrize("seed,epoch,n,g", [
    (0, 0, 64, 8), (7, 0, 256, 8), (7, 3, 512, 16), (1, 1, 40, 10),
    (2 ** 40 + 5, 2, 1000, 20), (2 ** 64 - 1, 2 ** 33 + 1, 97, 12)])
def test_sample_schedule_equals_the_reference(seed, epoch, n, g):
    """The same Philox key and domain tag: the permutation, every step's
    global and per-rank indices and the remaining set, bit for bit."""
    a = SampleSchedule(seed, epoch, n, g)
    b = jcc.SampleSchedule(seed, epoch, n, g)
    assert a.steps_per_epoch == b.steps_per_epoch
    np.testing.assert_array_equal(a.perm, b.perm)
    for step in range(a.steps_per_epoch + 2):
        np.testing.assert_array_equal(a.global_indices(step),
                                      b.global_indices(step))
        np.testing.assert_array_equal(a.remaining(step), b.remaining(step))
        for world in [w for w in (1, 2, 3, 4, 5) if g % w == 0]:
            for r in range(world):
                np.testing.assert_array_equal(
                    a.rank_indices(step, r, world),
                    b.rank_indices(step, r, world))


@pytest.mark.parametrize("call", [
    lambda m: m.SampleSchedule(0, 0, 0, 1),
    lambda m: m.SampleSchedule(0, 0, 4, 0),
    lambda m: m.SampleSchedule(0, 0, 4, 8),
    lambda m: m.SampleSchedule(0, 0, 40, 10).rank_indices(0, 0, 3),
    lambda m: m.SampleSchedule(0, 0, 40, 10).rank_indices(0, 2, 2),
    lambda m: m.SampleSchedule(0, 0, 40, 10).rank_indices(0, 0, 0),
], ids=["empty", "no-batch", "batch>epoch", "indivisible", "rank>=world",
        "world0"])
def test_sample_schedule_guards_match(call):
    msgs = {}
    for name, mod in PKGS.items():
        with pytest.raises(ValueError) as e:
            call(mod)
        msgs[name] = str(e.value)
    assert msgs["port"] == msgs["ref"]


# ---------------------------------------------------------------------------
# roundtrips (in-process, as tests/test_elastic_training.py)
# ---------------------------------------------------------------------------

def _world_state(rank, world, rows=12, dim=3):
    """Deterministic per-rank share of a cluster state."""
    w = np.arange(10, dtype=np.float64) * 1.5          # replicated
    full = (np.arange(rows * dim, dtype=np.float64)
            .reshape(rows, dim) + 0.25)                # sharded, axis 0
    piece = np.array_split(full, world, axis=0)[rank]
    rng = np.array([1000 + rank], dtype=np.int64)      # per-rank
    return {"replicated": {"w": w}, "sharded": {"emb": piece},
            "per_rank": {"rng": rng}}, full


def _save_world(root, world, step, async_save=False, pkg=pcc):
    handles = [pkg.ClusterCheckpoint(root, rank=r, world=world,
                                     every_steps=1, async_save=async_save,
                                     merge_timeout=30.0)
               for r in range(world)]
    # rank 0's sync save polls for every part before merging, so the
    # other ranks publish first (in a job they run in parallel)
    full = None
    for r in range(world - 1, -1, -1):
        st, full = _world_state(r, world)
        handles[r].save(step, **st)
    for h in handles:
        h.wait()
    return handles, full


def test_cluster_roundtrip_same_world(tmp_path):
    handles, _ = _save_world(str(tmp_path), world=2, step=3)
    for r in range(2):
        state, info = handles[r].restore()
        assert info["step"] == 3 and info["saved_world"] == 2
        st, _ = _world_state(r, 2)
        np.testing.assert_array_equal(state["w"], st["replicated"]["w"])
        np.testing.assert_array_equal(state["emb"], st["sharded"]["emb"])
        np.testing.assert_array_equal(state["rng"],
                                      st["per_rank"]["rng"])


def test_cluster_resize_restore_4_to_2(tmp_path):
    root = str(tmp_path)
    _, full = _save_world(root, world=4, step=5)
    new = ClusterCheckpoint(root, rank=0, world=2)
    for r in range(2):
        state, info = new.restore(rank=r, world=2)
        assert info["saved_world"] == 4
        np.testing.assert_array_equal(state["w"], np.arange(10) * 1.5)
        np.testing.assert_array_equal(
            state["emb"], np.array_split(full, 2, axis=0)[r])
        assert state["rng"] is None
    assert REGISTRY.get("paddle_tpu_elastic_resume_seconds").count >= 2


def test_uncommitted_parts_invisible_and_wrong_world_rejected(tmp_path):
    root = str(tmp_path)
    handles, _ = _save_world(root, world=2, step=2)
    before, info = handles[0].restore()
    assert info["step"] == 2
    st1, _ = _world_state(1, 2)
    handles[1].store.save_part(
        {"emb@shard0001": st1["sharded"]["emb"] * 7}, 4, 1, 2)
    after, info2 = ClusterCheckpoint(root, rank=0, world=2).restore()
    assert info2["step"] == 2
    for k in before:
        np.testing.assert_array_equal(after[k], before[k])
    # restore (rank 0) purged the stale part
    assert manifest_mod.list_parts(root, 4) == []
    st0, _ = _world_state(0, 2)
    handles[0].store.save_part(
        {"emb@shard0000": st0["sharded"]["emb"]}, 6, 0, 2)
    with pytest.raises(manifest_mod.ManifestError, match="world"):
        manifest_mod.merge_parts(root, 6, 1)


def test_async_roundtrip_same_world(tmp_path):
    handles, _ = _save_world(str(tmp_path), world=2, step=1,
                             async_save=True)
    state, info = handles[0].restore()
    assert info["step"] == 1
    st0, _ = _world_state(0, 2)
    np.testing.assert_array_equal(state["emb"], st0["sharded"]["emb"])


def test_seconds_cadence_via_intent_file(tmp_path):
    # the cadence is long enough that the first maybe_save falls inside
    # it on a loaded host (at 10 ms a 10 ms stall between the
    # constructor and that call armed step 1's intent instead)
    root = str(tmp_path)
    st, _ = _world_state(0, 1)
    ck = ClusterCheckpoint(root, rank=0, world=1, every_seconds=0.25,
                           async_save=False)
    assert ck.maybe_save(0, **st) is None
    time.sleep(0.3)
    assert ck.maybe_save(1, **st) is None     # arms an intent for 2
    assert os.path.exists(os.path.join(root, "intent-0000000002.json"))
    assert ck.maybe_save(2, **st) == 2
    assert not os.path.exists(
        os.path.join(root, "intent-0000000002.json"))
    assert ck.latest_step() == 2


def test_restore_refuses_non_cluster_manifest(tmp_path):
    CheckpointStore(str(tmp_path)).save({"a": np.zeros(3)}, step=1)
    with pytest.raises(ClusterCheckpointError, match="cluster"):
        ClusterCheckpoint(str(tmp_path), rank=0, world=1).restore()


def test_layout_guards(tmp_path):
    ck = ClusterCheckpoint(str(tmp_path), rank=0, world=1,
                           async_save=False)
    with pytest.raises(ValueError, match="two layout kinds"):
        ck.save(1, replicated={"a": np.zeros(2)},
                per_rank={"a": np.zeros(2)})
    with pytest.raises(ValueError, match="reserved"):
        ck.save(1, replicated={"a@x": np.zeros(2)})
    with pytest.raises(ValueError, match="scalars cannot be sharded"):
        ck.save(1, sharded={"s": torch.tensor(3.0)})
    with pytest.raises(ValueError, match="outside world"):
        ClusterCheckpoint(str(tmp_path), rank=2, world=2)


@pytest.mark.parametrize("async_save", [False, True])
def test_torch_tensors_save_and_bf16_refused(tmp_path, async_save):
    """A trainer hands its tensors straight in: float32 masters and
    int64 counters restore bit-equal as numpy; bfloat16 raises before
    anything is written."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(6, 4, generator=g)
    m = torch.randn(5, 3, generator=g)
    root = str(tmp_path)
    ck = ClusterCheckpoint(root, rank=0, world=1, async_save=async_save)
    ck.save(2, replicated={"w": w, "step": torch.tensor(2)},
            sharded={"m": m})
    ck.wait()
    state, info = ck.restore()
    assert info["step"] == 2
    np.testing.assert_array_equal(state["w"], w.numpy())
    np.testing.assert_array_equal(state["m"], m.numpy())
    assert state["step"].shape == () and int(state["step"]) == 2
    with pytest.raises(ValueError, match="bfloat16"):
        ck.save(4, replicated={"w": w.to(torch.bfloat16)})
    ck.wait()
    assert ck.latest_step() == 2


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("saved,restored", [(2, 2), (4, 2)])
@pytest.mark.parametrize("writer,reader", [("port", "ref"),
                                           ("ref", "port")])
def test_cluster_checkpoint_restores_across_packages(
        tmp_path, writer, reader, saved, restored):
    """One package's ranks save a cluster version (the async writer
    thread for the even worlds' parts and merge); the other package's
    ClusterCheckpoint restores every rank of the new world: replicated
    arrays whole, sharded ones cut on the new partition, per-rank ones
    only at the same world — all bit-equal, with the same info."""
    root = str(tmp_path)
    _, full = _save_world(root, world=saved, step=6, async_save=True,
                          pkg=PKGS[writer])
    for r in range(restored):
        infos, states = {}, {}
        for name, mod in PKGS.items():
            states[name], infos[name] = mod.ClusterCheckpoint(
                root, rank=r, world=restored).restore()
        assert infos["port"] == infos["ref"] == {
            "step": 6, "saved_world": saved, "extra": None}
        got = states[reader]
        assert set(got) == set(states[writer]) == {"w", "emb", "rng"}
        np.testing.assert_array_equal(got["w"], np.arange(10) * 1.5)
        want = np.array_split(full, restored, axis=0)[r]
        np.testing.assert_array_equal(got["emb"], want)
        assert got["emb"].dtype == want.dtype
        if saved == restored:
            np.testing.assert_array_equal(got["rng"], [1000 + r])
        else:
            assert got["rng"] is None and states[writer]["rng"] is None


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_uncommitted_parts_invisible_across_packages(tmp_path, writer):
    """A version whose parts never merged (rank 1's part missing) is
    invisible to both packages, which restore the previous one
    bit-equal; the reader's rank-0 restore purges the orphan part."""
    root = str(tmp_path)
    mod = PKGS[writer]
    _save_world(root, world=2, step=2, pkg=mod)
    st0, _ = _world_state(0, 2)
    orphan = mod.ClusterCheckpoint(root, rank=0, world=2,
                                   async_save=False)
    orphan.store.save_part({"w": st0["replicated"]["w"] * 3,
                            "emb@shard0000": st0["sharded"]["emb"] * 3},
                           4, 0, 2)
    assert [r for r, _ in manifest_mod.list_parts(root, 4)] == [0]
    for name in ("ref", "port") if writer == "port" else ("port", "ref"):
        state, info = PKGS[name].ClusterCheckpoint(
            root, rank=0, world=2).restore()
        assert info["step"] == 2, name
        np.testing.assert_array_equal(state["w"], st0["replicated"]["w"])
        np.testing.assert_array_equal(state["emb"], st0["sharded"]["emb"])
    assert manifest_mod.list_parts(root, 4) == []


@pytest.mark.parametrize("merge", ["sync", "async"])
def test_merge_gc_spares_a_save_in_flight(tmp_path, merge):
    """Rank 0's retention GC after a merge leaves what another rank's
    save still in flight has written or re-referenced: a temp file, a
    chunk no part references yet, an old chunk it deduplicates. It
    still collects what is older than the merged step's parts. (It used
    to sweep them all: the other rank's rename then failed, or its part
    referenced a chunk gone from disk.)"""
    from paddle_tpu_torch.checkpoint.chunks import digest_of
    root = str(tmp_path)
    st = CheckpointStore(root, keep=1)

    def arrays(step, r):
        return {f"a{r}": np.full(4, step * 10 + r, np.float32)}

    for r in range(2):
        st.save_part(arrays(1, r), 1, r, 2)
    st.merge_parts(1, 2)
    for r in range(2):
        st.save_part(arrays(2, r), 2, r, 2)
    # the parts of step 2 were written a minute ago, step 1's chunks
    # before them
    t_parts = time.time() - 60
    for _r, path in manifest_mod.list_parts(root, 2):
        os.utime(path, (t_parts, t_parts))
    old = {r: st.chunks._path(digest_of(arrays(1, r)["a" + str(r)]
                                        .tobytes())) for r in range(2)}
    for path in old.values():
        os.utime(path, (t_parts - 30, t_parts - 30))
    # rank 1's save of step 3, in flight: a chunk written, one deduped
    # (step 1's a0 again), one temp file mid-write
    fresh = st.chunks._path(st.chunks.put(b"rank 1, step 3"))
    assert st.chunks.put(arrays(1, 0)["a0"].tobytes()) \
        == os.path.basename(old[0])
    tmp = fresh + ".tmp.999999.1"
    with open(tmp, "wb") as f:
        f.write(b"half")
    if merge == "sync":
        st.merge_parts(2, 2)
    else:
        st.merge_parts_async(2, 2)
        st.wait()
    assert st.steps() == [2]
    assert os.path.exists(fresh) and os.path.exists(tmp)
    assert os.path.exists(old[0])          # re-referenced in flight
    assert not os.path.exists(old[1])      # step 1's alone: collected
    restored, _ = st.restore()
    assert restored["a0"][0] == 20 and restored["a1"][0] == 21

"""The port's checkpoint tier (paddle_tpu_torch/checkpoint), its fault
injector and the serving warm start, on the CPU.

  * the cases of tests/test_checkpoint.py for chunks, manifests, the
    store (numpy and torch state), the WAL and the metric names, against
    the port, plus the writer gauges and flight transitions of
    tests/test_debug_postmortem.py;
  * kill mid-save: a writer armed with PADDLE_PS_FAULT_KILL_AFTER_BYTES
    dies after 8 KB of chunk payload; restore returns the previous
    commit bit for bit and the recovering save dedups;
  * byte compatibility with the JAX package: each restores what the
    other saved, both write identical manifest ``arrays`` entries for
    the same state, and both refuse bfloat16;
  * serving: a checkpoint of either package's GPTDecodeModel starts the
    other's Engine and decodes the JAX engine's greedy tokens;
    warm_start on a live engine; a missing key raises KeyError;
  * the fault injector's knobs and the engine's serving_decode stall.

Size: the JAX package's checkpoint test GPT (vocab 64, hidden 32, 2
layers, 2 heads of 16), its weights drawn with initializer_range 0.5.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from paddle_tpu import checkpoint as jckpt
from paddle_tpu.distributed.fleet.runtime import fault_injection as jfi
from paddle_tpu.models.gpt import GPTConfig as JConfig
from paddle_tpu.serving.engine import Engine as JEngine
from paddle_tpu.serving.model import GPTDecodeModel as JModel
from paddle_tpu_torch import checkpoint as pckpt
from paddle_tpu_torch.checkpoint import (CheckpointStore, ChunkError,
                                         ChunkStore, ManifestError,
                                         RowJournal, ShardedArray,
                                         commit_manifest, committed_length,
                                         load_latest, replay_file)
from paddle_tpu_torch.distributed.fleet.runtime import \
    fault_injection as pfi
from paddle_tpu_torch.models import gpt as pgpt
from paddle_tpu_torch.observability import REGISTRY
from paddle_tpu_torch.observability import flight as pflight
from paddle_tpu_torch.observability import registry as pobs
from paddle_tpu_torch.serving import Engine, GPTDecodeModel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# initializer_range 0.5: at the default 0.02 this GPT greedily repeats
# the prompt's last token whatever its weights, and token parity would
# not tell two checkpoints apart
SIZE = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
            max_position_embeddings=64, initializer_range=0.5)
ENGINE_KW = dict(num_slots=2, num_pages=16, page_size=4)
PROMPTS = [np.array([1, 2, 3], np.int32),
           np.array([7, 60, 5, 9, 33], np.int32),
           np.arange(10, 21, dtype=np.int32)]


# ---------------------------------------------------------------------------
# chunk store
# ---------------------------------------------------------------------------

def test_chunk_put_get_dedup(tmp_path):
    cs = ChunkStore(str(tmp_path))
    d1 = cs.put(b"hello world")
    assert cs.get(d1) == b"hello world"
    assert cs.chunks_written == 1 and cs.dedup_hits == 0
    d2 = cs.put(b"hello world")  # identical content: never rewritten
    assert d2 == d1 and cs.chunks_written == 1 and cs.dedup_hits == 1
    d3 = cs.put(b"other")
    assert d3 != d1 and cs.chunks_written == 2


def test_chunk_corruption_detected(tmp_path):
    cs = ChunkStore(str(tmp_path))
    d = cs.put(b"payload-bytes")
    with open(cs._path(d), "wb") as f:
        f.write(b"payload-BYTES")
    with pytest.raises(ChunkError, match="corrupt"):
        cs.get(d)
    with pytest.raises(ChunkError, match="missing"):
        cs.get("0" * 64)


def test_chunk_gc_keeps_live(tmp_path):
    cs = ChunkStore(str(tmp_path))
    keep = cs.put(b"keep me")
    drop = cs.put(b"drop me")
    assert cs.gc({keep}) == 1
    assert cs.get(keep) == b"keep me"
    assert not cs.has(drop)


# ---------------------------------------------------------------------------
# manifests
# ---------------------------------------------------------------------------

def test_manifest_commit_and_crc(tmp_path):
    root = str(tmp_path)
    commit_manifest(root, {"step": 1, "meta": {"k": "v"}, "arrays": {}})
    payload = load_latest(root)
    assert payload["step"] == 1 and payload["meta"] == {"k": "v"}


def test_manifest_corrupt_newest_falls_back(tmp_path):
    root = str(tmp_path)
    commit_manifest(root, {"step": 1, "meta": "good", "arrays": {}})
    p2 = commit_manifest(root, {"step": 2, "meta": "newer", "arrays": {}})
    with open(p2, "r+b") as f:  # flip a byte inside the doc
        f.seek(30)
        f.write(b"X")
    payload = load_latest(root)  # CRC-bad newest skipped, not fatal
    assert payload["step"] == 1 and payload["meta"] == "good"
    with pytest.raises(ManifestError):
        load_latest(str(tmp_path / "empty"))


# ---------------------------------------------------------------------------
# store: round trip, dedup, async, retention, resharding
# ---------------------------------------------------------------------------

def _state():
    rs = np.random.RandomState(0)
    return {
        "f32": rs.randn(100, 100).astype(np.float32),
        "f16": rs.randn(33, 9).astype(np.float16),
        "i64": np.arange(7, dtype=np.int64),
        "scalar": np.float32(2.5),
        "empty": np.empty((0, 5), np.float32),
        "noncontig": np.arange(64, dtype=np.float32).reshape(8, 8).T,
    }


def _torch_state():
    """_state() as torch tensors (the 0-d one a 0-d tensor, the
    transposed one a non-contiguous view)."""
    out = {k: torch.from_numpy(np.ascontiguousarray(v))
           for k, v in _state().items() if k != "noncontig"}
    out["scalar"] = torch.tensor(np.float32(2.5))
    out["noncontig"] = torch.arange(64, dtype=torch.float32).reshape(8, 8).T
    return out


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_store_roundtrip_dtypes_shapes(tmp_path, kind):
    st = CheckpointStore(str(tmp_path), chunk_bytes=1024)
    state = _state() if kind == "numpy" else _torch_state()
    step = st.save(state, meta={"note": "round-trip"})
    out, meta = st.restore()
    assert meta == {"note": "round-trip"} and step == 1
    for k, want in _state().items():
        want = np.asarray(want)
        np.testing.assert_array_equal(out[k], want)
        assert out[k].shape == want.shape and out[k].dtype == want.dtype


def test_store_subset_restore(tmp_path):
    st = CheckpointStore(str(tmp_path))
    st.save(_state())
    out, _ = st.restore(names={"i64"})
    assert set(out) == {"i64"}


def test_incremental_save_dedups_unchanged_chunks(tmp_path):
    st = CheckpointStore(str(tmp_path), chunk_bytes=1024)
    state = _state()
    st.save(state)
    mutated = dict(state)
    mutated["f32"] = state["f32"].copy()
    mutated["f32"][0, 0] += 1.0  # 1 of ~40 chunks of f32 changes
    w0, h0 = st.chunks.chunks_written, st.chunks.dedup_hits
    st.save(mutated)
    assert st.chunks.chunks_written - w0 == 1
    assert st.chunks.dedup_hits - h0 > 30  # everything else re-referenced


def test_async_save_matches_sync_and_surfaces_errors(tmp_path):
    st = CheckpointStore(str(tmp_path / "a"), chunk_bytes=4096)
    state = _torch_state()
    step = st.save_async(state)
    # the caller may mutate its tensors at once: host copies were taken
    state["f32"].fill_(-1.0)
    st.wait()
    out, _ = st.restore(step)
    np.testing.assert_array_equal(out["f32"], _state()["f32"])
    sync = CheckpointStore(str(tmp_path / "s"), chunk_bytes=4096)
    sync.save(_state())
    assert sync.latest_manifest()["arrays"] == st.latest_manifest()["arrays"]
    # a writer error surfaces on wait(), not silently
    bad = CheckpointStore(str(tmp_path / "b"))
    bad.save_async({"x": np.arange(4)})
    bad.chunks.dir = os.path.join(str(tmp_path), "nope\0bad")
    with pytest.raises(Exception):
        bad.save_async({"x": np.arange(4)})
        bad.wait()


def test_retention_keeps_newest_and_gcs_chunks(tmp_path):
    st = CheckpointStore(str(tmp_path), chunk_bytes=512, keep=2)
    for i in range(4):
        st.save({"w": torch.full((64,), float(i))})
    assert st.steps() == [3, 4]
    out, _ = st.restore(3)
    np.testing.assert_array_equal(out["w"], np.full((64,), 2.0))
    live = set()
    for s in (3, 4):
        for ent in st.latest_manifest(s)["arrays"].values():
            live.update(c["h"] for c in ent["chunks"])
    assert st.chunks.all_digests() == live


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_reshard_restore_pieces(tmp_path, kind):
    """Saved from a 4-piece layout, restored as 1/2/5 shards — the
    chunk grid is layout-independent."""
    st = CheckpointStore(str(tmp_path), chunk_bytes=256)
    big = np.arange(37 * 8, dtype=np.float32).reshape(37, 8)
    pieces = np.array_split(big, 4, axis=0)
    if kind == "torch":
        pieces = [torch.from_numpy(p) for p in pieces]
    st.save({"w": ShardedArray(pieces)})
    np.testing.assert_array_equal(st.restore_array("w"), big)
    for k in (1, 2, 5):
        parts = [st.restore_shard("w", i, k) for i in range(k)]
        np.testing.assert_array_equal(np.concatenate(parts), big)
    ent = st.latest_manifest()["arrays"]["w"]
    np.testing.assert_array_equal(st.read_rows(ent, 3, 11), big[3:11])
    np.testing.assert_array_equal(st.materialize(ent), big)
    # re-saving from another layout re-references every chunk
    h0 = st.chunks.dedup_hits
    st.save({"w": ShardedArray(np.array_split(big, 3, axis=0))})
    assert st.chunks.dedup_hits - h0 == len(ent["chunks"])


def test_save_part_and_merge_parts(tmp_path):
    st = CheckpointStore(str(tmp_path), chunk_bytes=256)
    st.save_part({"a": np.arange(10.0)}, step=5, rank=0, world=2)
    with pytest.raises(ManifestError, match="missing part"):
        st.merge_parts(5, 2)
    assert st.steps() == []     # an unmerged save is invisible
    st.save_part({"b": torch.ones(3, 2)}, step=5, rank=1, world=2)
    assert st.merge_parts(5, 2, meta={"m": 1}) == 5
    out, meta = st.restore()
    assert meta == {"m": 1} and set(out) == {"a", "b"}
    np.testing.assert_array_equal(out["b"], np.ones((3, 2), np.float32))


# ---------------------------------------------------------------------------
# crash consistency: kill mid-save, restore the previous commit
# ---------------------------------------------------------------------------

CRASH_WRITER = '''
import json, os, sys
import numpy as np
from paddle_tpu_torch.checkpoint import CheckpointStore

def make_state(mutated):
    rs = np.random.RandomState(1234)
    state = {"w_embed": rs.randn(256, 64).astype(np.float32),
             "w_out": rs.randn(64, 32).astype(np.float32),
             "steps": np.int64(7)}
    if mutated:
        state["w_embed"] = state["w_embed"].copy()
        state["w_embed"][:2] += 0.5
        state["steps"] = np.int64(8)
    return state

store = CheckpointStore(os.environ["CKPT_ROOT"], chunk_bytes=4096)
phase = os.environ["CKPT_PHASE"]
if phase == "commit":
    store.save(make_state(False), meta={"phase": "v1"})
elif phase == "crash":
    store.save(make_state(True), meta={"phase": "v2"})
    sys.exit("writer was supposed to die mid-save")
else:
    store.save(make_state(True), meta={"phase": "v2"})
    print(json.dumps({"dedup_hits": store.chunks.dedup_hits}))
'''


def _run_writer(script, root, phase, extra_env=None, check=True):
    env = dict(os.environ, CKPT_ROOT=str(root), CKPT_PHASE=phase)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("PADDLE_PS_FAULT_KILL_AFTER_BYTES", None)
    env.update(extra_env or {})
    res = subprocess.run([sys.executable, str(script)], env=env,
                         capture_output=True, text=True, timeout=120)
    if check:
        assert res.returncode == 0, res.stdout + res.stderr
    return res


def test_kill_mid_save_restores_previous_commit_bit_for_bit(tmp_path):
    script = tmp_path / "writer.py"
    script.write_text(CRASH_WRITER)
    root = tmp_path / "ckpt"
    _run_writer(script, root, "commit")
    v1, meta = CheckpointStore(str(root)).restore()
    assert meta == {"phase": "v1"}

    # the writer dies after 8 KB of chunk payload — past some chunk
    # renames, before the manifest commit
    res = _run_writer(script, root, "crash", check=False, extra_env={
        "PADDLE_PS_FAULT_KILL_AFTER_BYTES": "8192"})
    assert res.returncode == pfi.KILL_EXIT_CODE, res.stdout + res.stderr

    after, meta2 = CheckpointStore(str(root)).restore()
    assert meta2 == {"phase": "v1"} and set(after) == set(v1)
    for k in v1:
        assert after[k].dtype == v1[k].dtype
        np.testing.assert_array_equal(after[k], v1[k])

    res = _run_writer(script, root, "recover")
    assert json.loads(res.stdout.strip().splitlines()[-1])["dedup_hits"] > 0
    v2, meta3 = CheckpointStore(str(root)).restore()
    assert meta3 == {"phase": "v2"}
    assert not np.array_equal(v2["w_embed"], v1["w_embed"])
    np.testing.assert_array_equal(v2["w_out"], v1["w_out"])


# ---------------------------------------------------------------------------
# WAL
# ---------------------------------------------------------------------------

def test_wal_append_replay_roundtrip(tmp_path):
    path = str(tmp_path / "j.wal")
    j = RowJournal(path)
    n = j.append_rows("emb", [3, 5], np.ones((2, 4), np.float32), dim=4,
                      req_id=77, extra=b"RE")
    assert n == j.bytes_written and j.rows_appended == 2
    j.append_mark(99, extra=b"XY")
    j.close()
    recs = list(replay_file(path))
    assert [r["kind"] for r in recs] == ["rows", "mark"]
    assert recs[0]["req_id"] == 77 and recs[0]["extra"] == b"RE"
    np.testing.assert_array_equal(recs[0]["idx"], [3, 5])
    np.testing.assert_array_equal(recs[0]["values"],
                                  np.ones((2, 4), np.float32))
    assert recs[1]["req_id"] == 99 and recs[1]["extra"] == b"XY"


def test_wal_recover_truncates_torn_tail_before_appending(tmp_path):
    path = str(tmp_path / "j.wal")
    j = RowJournal(path)
    j.append_rows("t", [1], np.zeros((1, 2)), dim=2)
    j.close()
    good = committed_length(path)
    with open(path, "ab") as f:  # crash mid-append: partial record
        f.write(b"\x4c\x57\x54\x50partial-garbage")
    j2 = RowJournal(path, recover=True)
    assert os.path.getsize(path) == good
    j2.append_rows("t", [2], np.ones((1, 2)), dim=2)
    j2.close()
    assert [int(r["idx"][0]) for r in replay_file(path)] == [1, 2]


def test_wal_torn_tail_stops_cleanly(tmp_path):
    path = str(tmp_path / "j.wal")
    j = RowJournal(path)
    j.append_rows("t", [1], np.zeros((1, 2)), dim=2)
    j.append_rows("t", [2], np.ones((1, 2)), dim=2)
    j.close()
    whole = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(whole[:len(whole) - 10])
    recs = list(replay_file(path))
    assert len(recs) == 1 and recs[0]["idx"][0] == 1
    with open(path, "wb") as f:
        f.write(whole + b"\xde\xad\xbe\xef")
    assert len(list(replay_file(path))) == 2


def test_wal_file_reads_in_the_jax_package(tmp_path):
    path = str(tmp_path / "j.wal")
    j = RowJournal(path)
    j.append_rows("emb", [4, 9], np.arange(6, dtype=np.float32)
                  .reshape(2, 3), dim=3, req_id=5, extra=b"Z")
    j.close()
    recs = list(jckpt.replay_file(path))
    assert len(recs) == 1 and recs[0]["req_id"] == 5
    np.testing.assert_array_equal(recs[0]["values"],
                                  np.arange(6).reshape(2, 3))
    assert jckpt.committed_length(path) == committed_length(path)


# ---------------------------------------------------------------------------
# metrics and flight events
# ---------------------------------------------------------------------------

def test_ckpt_metrics_registered(tmp_path):
    CheckpointStore(str(tmp_path)).save({"x": np.arange(8)})
    j = RowJournal(str(tmp_path / "j.wal"))
    j.append_rows("t", [1], np.zeros((1, 2)), dim=2)
    j.close()
    text = pobs.prometheus_text()
    for name in ("paddle_tpu_ckpt_save_seconds",
                 "paddle_tpu_ckpt_restore_seconds",
                 "paddle_tpu_ckpt_saves_total",
                 "paddle_tpu_ckpt_bytes_written_total",
                 "paddle_tpu_ckpt_chunks_written_total",
                 "paddle_tpu_ckpt_manifests_committed_total",
                 "paddle_tpu_ckpt_wal_rows_appended_total",
                 "paddle_tpu_ckpt_wal_records_total"):
        assert name in text, name
    assert 'paddle_tpu_ckpt_bytes_written_total{tier="chunk"}' in text
    assert 'paddle_tpu_ckpt_bytes_written_total{tier="manifest"}' in text


def test_ckpt_writer_gauges_and_flight_transitions(tmp_path):
    depth = REGISTRY.get("paddle_tpu_ckpt_writer_queue_depth")
    pending = REGISTRY.get("paddle_tpu_ckpt_writer_pending_bytes")
    inflight = REGISTRY.get("paddle_tpu_ckpt_inflight_save_seconds")
    st = CheckpointStore(str(tmp_path))
    state = {"w": torch.arange(1024, dtype=torch.float32)}
    pflight.RECORDER.clear()
    step = st.save_async(state)
    st.wait()
    assert depth.value == 0 and pending.value == 0 and inflight.value == 0
    events = pflight.RECORDER.events("ckpt")
    kinds = [e.kind for e in events]
    for k in ("enqueue", "write_start", "write_done", "manifest_commit"):
        assert k in kinds, (k, kinds)
    enq = [e for e in events if e.kind == "enqueue"][0]
    assert enq.attrs["bytes"] == 4096 and enq.attrs["step"] == step
    got, _meta = st.restore()
    np.testing.assert_array_equal(got["w"], state["w"].numpy())


# ---------------------------------------------------------------------------
# byte compatibility with the JAX package's store
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_restores_across_packages(tmp_path, writer):
    W, R = (jckpt, pckpt) if writer == "jax" else (pckpt, jckpt)
    big = np.arange(37 * 8, dtype=np.float32).reshape(37, 8)
    state = dict(_state(), sharded=W.ShardedArray(
        np.array_split(big, 4, axis=0)))
    W.CheckpointStore(str(tmp_path), chunk_bytes=256).save(
        state, meta={"by": writer})
    out, meta = R.CheckpointStore(str(tmp_path)).restore()
    assert meta == {"by": writer}
    for k, want in dict(_state(), sharded=big).items():
        want = np.asarray(want)
        np.testing.assert_array_equal(out[k], want)
        assert out[k].shape == want.shape and out[k].dtype == want.dtype
    np.testing.assert_array_equal(
        R.CheckpointStore(str(tmp_path)).restore_shard("sharded", 1, 3),
        np.array_split(big, 3, axis=0)[1])


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_both_packages_write_identical_manifest_entries(tmp_path, kind):
    jckpt.CheckpointStore(str(tmp_path / "j"), chunk_bytes=512).save(
        _state())
    pckpt.CheckpointStore(str(tmp_path / "p"), chunk_bytes=512).save(
        _state() if kind == "numpy" else _torch_state())
    ja = jckpt.load_latest(str(tmp_path / "j"))["arrays"]
    pa = pckpt.load_latest(str(tmp_path / "p"))["arrays"]
    assert list(ja) == list(pa) and ja == pa
    assert sorted(os.listdir(tmp_path / "j" / "chunks")) \
        == sorted(os.listdir(tmp_path / "p" / "chunks"))


def test_bfloat16_raises_in_both_packages(tmp_path):
    import jax.numpy as jnp
    with pytest.raises(ValueError):
        jckpt.CheckpointStore(str(tmp_path / "j")).save(
            {"w": jnp.ones((4, 4), jnp.bfloat16)})
    with pytest.raises(ValueError, match="bfloat16"):
        pckpt.CheckpointStore(str(tmp_path / "p")).save(
            {"w": torch.ones(4, 4, dtype=torch.bfloat16)})
    assert pckpt.CheckpointStore(str(tmp_path / "p")).steps() == []


# ---------------------------------------------------------------------------
# serving: checkpoints across packages, warm start
# ---------------------------------------------------------------------------

def test_gpt_config_fields_match_the_jax_package():
    assert dataclasses.asdict(pgpt.GPTConfig()).keys() \
        == dataclasses.asdict(JConfig()).keys()
    assert dataclasses.asdict(pgpt.GPTConfig(**SIZE)) \
        == dataclasses.asdict(JConfig(**SIZE))
    assert dataclasses.asdict(pgpt.GPTConfig(**SIZE, num_experts=2)) \
        == dataclasses.asdict(JConfig(**SIZE, num_experts=2))


def test_param_shapes_is_the_init_tree():
    cfg = pgpt.GPTConfig(**SIZE)
    tree = pgpt.init_gpt_params(cfg, seed=0)
    shapes = pgpt.param_shapes(cfg)
    assert set(shapes) == set(tree)
    assert {k: v.shape for k, v in tree["blocks"].items()} \
        == shapes["blocks"]
    assert all(tree[k].shape == shapes[k] for k in tree if k != "blocks")


def _greedy(eng, prompts=PROMPTS, n=8):
    reqs = [eng.submit(p, n) for p in prompts]
    eng.run_until_idle()
    return [r.result(1.0).tolist() for r in reqs]


@pytest.fixture(scope="module")
def jax_source(tmp_path_factory):
    """A JAX-package model (seed 3), its checkpoint, its greedy tokens."""
    root = str(tmp_path_factory.mktemp("jax_gpt"))
    src = JModel(JConfig(**SIZE), seed=3)
    src.save_checkpoint(root)
    return src, root, _greedy(JEngine(src, **ENGINE_KW))


def test_jax_checkpoint_starts_the_port_engine(jax_source):
    src, root, want = jax_source
    eng = Engine.from_checkpoint(root, device="cpu", **ENGINE_KW)
    assert dataclasses.asdict(eng.model.cfg) == dataclasses.asdict(src.cfg)
    assert eng.device.type == "cpu"
    assert _greedy(eng) == want


def test_port_checkpoint_starts_the_jax_engine(jax_source, tmp_path):
    src, _root, want = jax_source
    port = GPTDecodeModel(pgpt.GPTConfig(**SIZE), seed=3, device="cpu")
    root = str(tmp_path)
    assert port.save_checkpoint(root) == 1
    jeng = JEngine.from_checkpoint(root, **ENGINE_KW)
    assert jeng.model.cfg == src.cfg
    assert _greedy(jeng) == want
    assert _greedy(Engine(port, **ENGINE_KW)) == want


def test_checkpoint_keys_and_entries_match_the_jax_package(jax_source,
                                                           tmp_path):
    _src, jroot, _want = jax_source
    GPTDecodeModel(pgpt.GPTConfig(**SIZE), seed=3,
                   device="cpu").save_checkpoint(str(tmp_path))
    ja = jckpt.load_latest(jroot)
    pa = pckpt.load_latest(str(tmp_path))
    assert list(pa["arrays"]) == list(ja["arrays"])
    assert "['blocks']['wq']" in pa["arrays"]
    assert pa["arrays"] == ja["arrays"] and pa["meta"] == ja["meta"]
    # a second save of the same weights writes nothing new
    st = CheckpointStore(str(tmp_path))
    n = len(st.chunks.all_digests())
    GPTDecodeModel(pgpt.GPTConfig(**SIZE), seed=3,
                   device="cpu").save_checkpoint(str(tmp_path))
    assert len(st.chunks.all_digests()) == n and st.steps() == [1, 2]


def test_warm_start_flips_a_live_engine(jax_source):
    src, root, want = jax_source
    other = GPTDecodeModel(pgpt.GPTConfig(**SIZE), seed=9, device="cpu")
    eng = Engine(other, **ENGINE_KW)
    assert eng.stats()["model_version"] == 0
    with eng:                           # the scheduler thread runs
        before = eng.generate(PROMPTS[0], 8, timeout=60).tolist()
        queued = eng.submit(PROMPTS[1], 8)
        old = eng.model.params
        eng.warm_start(root, version=7)
        assert eng.model.params is not old      # a reference swap
        queued.result(60)
        after = [eng.generate(p, 8, timeout=60).tolist() for p in PROMPTS]
    assert after == want and before != want[0]
    assert eng.stats()["model_version"] == 7
    # the flip left the old tensors alone
    assert torch.equal(old["wte"], GPTDecodeModel(
        pgpt.GPTConfig(**SIZE), seed=9, device="cpu").params["wte"])
    # the pools rebuilt after a flip still serve the new weights
    eng._rebuild_on_failure = True
    eng._recover_cache("test")
    assert _greedy(eng) == want


def test_warm_start_version_defaults_to_step(jax_source):
    _src, root, want = jax_source
    eng = Engine(GPTDecodeModel(pgpt.GPTConfig(**SIZE), seed=9,
                                device="cpu"), **ENGINE_KW)
    eng.warm_start(root, step=1)
    assert eng.stats()["model_version"] == 1 and _greedy(eng) == want


def test_checkpoint_missing_a_key_raises(jax_source, tmp_path):
    _src, root, _want = jax_source
    arrays, meta = pckpt.CheckpointStore(root).restore()
    del arrays["['blocks']['w_up']"]
    pckpt.CheckpointStore(str(tmp_path / "cut")).save(arrays, meta=meta)
    with pytest.raises(KeyError, match=r"\['blocks'\]\['w_up'\]"):
        Engine.from_checkpoint(str(tmp_path / "cut"), device="cpu",
                               **ENGINE_KW)
    live = Engine(GPTDecodeModel(pgpt.GPTConfig(**SIZE), device="cpu"),
                  **ENGINE_KW)
    old = live.model.params
    with pytest.raises(KeyError, match="w_up"):
        live.warm_start(str(tmp_path / "cut"))
    assert live.model.params is old and live.model_version == 0
    # no config in the meta: raises, no seeded init instead
    pckpt.CheckpointStore(str(tmp_path / "nocfg")).save(arrays)
    with pytest.raises(ValueError, match="no model config"):
        GPTDecodeModel.from_checkpoint(str(tmp_path / "nocfg"),
                                       device="cpu")


def test_from_checkpoint_casts_to_the_template_dtype(jax_source, tmp_path):
    _src, root, want = jax_source
    arrays, meta = pckpt.CheckpointStore(root).restore()
    half = {k: v.astype(np.float16) for k, v in arrays.items()}
    pckpt.CheckpointStore(str(tmp_path)).save(half, meta=meta)
    m = GPTDecodeModel.from_checkpoint(str(tmp_path), device="cpu")
    assert all(t.dtype == torch.float32 for t in m.params["blocks"][0]
               .values())
    assert m.params["wte"].dtype == torch.float32


def test_from_checkpoint_needs_a_card_by_default(jax_source):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine.from_checkpoint(jax_source[1], **ENGINE_KW)


# ---------------------------------------------------------------------------
# the fault injector
# ---------------------------------------------------------------------------

def test_fault_knobs_match_the_jax_package(monkeypatch):
    assert pfi.KNOWN_FAULT_KNOBS == jfi.KNOWN_FAULT_KNOBS
    assert pfi.KILL_EXIT_CODE == jfi.KILL_EXIT_CODE
    for k in list(os.environ):
        if k.startswith("PADDLE_PS_FAULT_"):
            monkeypatch.delenv(k)
    p, j = pfi.FaultInjector.from_env(), jfi.FaultInjector.from_env()
    skip = ("_rng", "_lock")
    assert {k: v for k, v in vars(p).items() if k not in skip} \
        == {k: v for k, v in vars(j).items() if k not in skip}
    assert not p.active
    env = {"PADDLE_PS_FAULT_STALL": "0.5",
           "PADDLE_PS_FAULT_STALL_POINT": "serving_decode",
           "PADDLE_PS_FAULT_KILL_AFTER_BYTES": "4096",
           "PADDLE_PS_FAULT_FRAME_ACTION": "drop",
           "PADDLE_PS_FAULT_COLD_ROW": "17", "PADDLE_PS_FAULT_SEED": "3"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    p, j = pfi.FaultInjector.from_env(), jfi.FaultInjector.from_env()
    assert {k: v for k, v in vars(p).items() if k not in skip} \
        == {k: v for k, v in vars(j).items() if k not in skip}
    assert p.active and p.stall == 0.5 and p.kill_after_bytes == 4096
    assert p.frame_fault(5, None) == ("drop", 0.2)
    assert p.frame_fault(5, None) is None        # one-shot


def test_fault_injector_warns_on_unknown_knob(monkeypatch, caplog):
    monkeypatch.setenv("PADDLE_PS_FAULT_STAL", "1")
    with caplog.at_level("WARNING"):
        inj = pfi.FaultInjector.from_env()
    assert "PADDLE_PS_FAULT_STAL" in caplog.text and not inj.active


def test_injector_is_process_wide_and_resettable(monkeypatch):
    monkeypatch.setenv("PADDLE_PS_FAULT_DELAY", "0.25")
    pfi.reset_injector()
    try:
        inj = pfi.injector()
        assert inj is pfi.injector() and inj.delay == 0.25
        mine = pfi.FaultInjector(stall=0.1)
        pfi.reset_injector(mine)
        assert pfi.injector() is mine
    finally:
        pfi.reset_injector()


def test_serving_decode_stall_hook():
    stall = 0.3
    eng = Engine(GPTDecodeModel(pgpt.GPTConfig(**SIZE), device="cpu"),
                 **ENGINE_KW)
    eng.submit(PROMPTS[0], 4)
    eng.step()                          # admit + prefill + first decode
    inj = pfi.FaultInjector(stall=stall, stall_point="serving_decode")
    pfi.reset_injector(inj)
    try:
        t0 = time.perf_counter()
        assert eng.step()
        took = time.perf_counter() - t0
    finally:
        pfi.reset_injector()
    assert took >= stall and inj.counters["stalled"] == 1
    # another stall point leaves the decode step alone
    other = pfi.FaultInjector(stall=stall, stall_point="dispatch")
    pfi.reset_injector(other)
    try:
        eng.step()
    finally:
        pfi.reset_injector()
    assert other.counters["stalled"] == 0


# ---------------------------------------------------------------------------
# no pickle on the restore path
# ---------------------------------------------------------------------------

def test_no_pickle_check_covers_the_port_trees():
    roots = [os.path.join("paddle_tpu_torch", "checkpoint"),
             os.path.join("paddle_tpu_torch", "distributed")]
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts",
                                      "check_no_wire_pickle.py"),
         *[os.path.join(REPO, r) for r in roots]],
        capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stdout + res.stderr
    for r in roots:
        assert r in res.stdout, res.stdout

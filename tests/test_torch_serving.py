"""The port's serving tier (paddle_tpu_torch/serving) on the CPU.

  * host-only policy carried over from the JAX package's tests: page
    pool, scheduler, refcounts, defrag, prefix cache;
  * the decode model: prefill / prefill_tail / decode logits and KV
    pages against the JAX GPTDecodeModel within 1e-4, weights through
    params_from_jax (and init_gpt_params bit-identical);
  * the engine end to end: greedy tokens identical to the JAX Engine for
    the same prompts, identical with the prefix cache on and off, seeded
    sampled requests identical, plus lifecycle cases (deadline, poison
    prefill, cancel, defrag) and the no-card default raising.

Size: hidden 128, 2 heads of 64, 2 layers, vocab 512, page_size 8.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.models import gpt as jgpt
from paddle_tpu.serving import Engine as JEngine
from paddle_tpu.serving import GPTDecodeModel as JModel
from paddle_tpu_torch.models import gpt as pgpt
from paddle_tpu_torch.serving import (Engine, GPTDecodeModel, PagePool,
                                      PrefixCache, QueueFull, Request,
                                      Scheduler, defrag_plan, pages_needed)

SIZE = dict(vocab_size=512, hidden_size=128, num_heads=2, num_layers=2,
            max_position_embeddings=128)
ENGINE_KW = dict(num_slots=4, num_pages=64, page_size=8, max_seq_len=64)
# logits: f32 with sums in another order than XLA's, over 2 layers
LOGIT_TOL = 1e-4
# a greedy token may differ only where JAX's top-2 logits are closer
# than this (then either token is a correct argmax within LOGIT_TOL)
TIE_TOL = 2 * LOGIT_TOL


@pytest.fixture(scope="module")
def models():
    cfg_j = jgpt.GPTConfig(**SIZE)
    cfg_p = pgpt.GPTConfig(**SIZE)
    tree = pgpt.init_gpt_params(cfg_p, seed=0)
    return (cfg_j, JModel(cfg_j, params=tree), cfg_p,
            GPTDecodeModel(cfg_p, params=tree, device="cpu"))


# ---------------------------------------------------------------------------
# host-only policy (carried over)
# ---------------------------------------------------------------------------

def test_page_pool_alloc_free_admission():
    pool = PagePool(num_pages=8, page_size=4)
    assert pool.free_pages == 8 and pool.occupancy == 0.0
    assert pages_needed(1, 4) == 1 and pages_needed(9, 4) == 3
    assert pool.can_admit(32) and not pool.can_admit(33)
    t = pool.alloc_table(10)
    assert len(t.pages) == 3 and pool.used_pages == 3
    assert pool.alloc(6) is None
    assert pool.alloc_failures == 1
    t2 = pool.alloc_table(20)
    assert pool.free_pages == 0 and not pool.can_admit(1)
    pool.free(t)
    assert pool.free_pages == 3 and t.pages == []
    pool.free(t2)
    assert pool.free_pages == 8
    assert pool.stats()["alloc_count"] == 8


def test_page_pool_double_free_rejected():
    pool = PagePool(4, 4)
    t = pool.alloc_table(4)
    pages = list(t.pages)
    pool.free(t)
    with pytest.raises(ValueError, match="double free"):
        pool.free(pages)


def test_page_table_padding_and_defrag_plan():
    pool = PagePool(8, 4)
    a = pool.alloc_table(8)
    b = pool.alloc_table(4)
    pool.free(a)
    c = pool.alloc_table(4)
    assert b.padded(4, fill=99) == [2, 99, 99, 99]
    wide = pool.alloc_table(16)
    with pytest.raises(ValueError, match="bucket width"):
        wide.padded(1)
    pool.free(wide)
    mapping = defrag_plan(pool, [b, c])
    assert sorted(b.pages + c.pages) == [0, 1]
    assert pool.free_pages == 8 - 2
    assert set(mapping.values()) == {0, 1}


def _mk_sched(num_pages=16, page_size=4, num_slots=2, max_queue=4):
    clock = {"t": 0.0}
    pool = PagePool(num_pages, page_size)
    s = Scheduler(pool, num_slots, max_seq_len=num_pages * page_size,
                  max_queue=max_queue, now=lambda: clock["t"])
    return s, pool, clock


def test_scheduler_admission_capacity_and_fifo():
    s, pool, _ = _mk_sched(num_pages=4, page_size=4, num_slots=2)
    r1 = s.submit(Request([1] * 8, 4))
    r2 = s.submit(Request([1] * 4, 4))
    r3 = s.submit(Request([1], 1))
    assert s.admit() == [r1] and r1.slot == 0 and pool.used_pages == 3
    assert s.admit() == []
    s.evict(r1, "done")
    assert pool.used_pages == 0
    assert s.admit() == [r2, r3]
    assert {r2.slot, r3.slot} == {0, 1}


def test_scheduler_eos_and_max_tokens_eviction():
    s, pool, _ = _mk_sched()
    r = s.submit(Request([1, 2], 3, eos_id=7))
    s.admit()
    assert not s.record_token(r, 5)
    assert s.record_token(r, 7)
    assert r.status == "done" and r.generated == [5, 7]
    assert pool.used_pages == 0 and s.completed == 1
    r2 = s.submit(Request([1], 2))
    s.admit()
    assert not s.record_token(r2, 3)
    assert s.record_token(r2, 4)
    assert r2.status == "done" and r2.result().tolist() == [3, 4]


def test_scheduler_deadline_preemption_frees_pages():
    s, pool, clock = _mk_sched(num_pages=4, page_size=4)
    r_run = s.submit(Request([1] * 4, 8, deadline=5.0))
    r_q = s.submit(Request([1] * 4, 8, deadline=1.0))
    assert s.admit() == [r_run]
    s.record_token(r_run, 2)
    clock["t"] = 2.0
    assert s.expire_deadlines() == [r_q] and r_q.status == "deadline"
    clock["t"] = 6.0
    assert s.expire_deadlines() == [r_run] and r_run.status == "deadline"
    assert r_run.result().tolist() == [2]
    assert pool.used_pages == 0
    assert s.preemptions == 1 and s.slots == [None, None]


def test_scheduler_backpressure():
    s, _, _ = _mk_sched(max_queue=2)
    s.submit(Request([1], 1))
    s.submit(Request([1], 1))
    with pytest.raises(QueueFull):
        s.submit(Request([1], 1))
    assert s.rejected == 1
    with pytest.raises(ValueError, match="max_seq_len"):
        s.submit(Request([1] * 60, 10))


def test_pool_refcounts_share_and_recycle():
    pool = PagePool(8, 4)
    t = pool.alloc_table(8)
    p0, p1 = t.pages
    pool.ref([p0, p1])
    assert pool.refcount(p0) == 2 and pool.shared_pages == 2
    frees_before = pool.free_count
    pool.free(t)
    assert pool.refcount(p0) == 1 and pool.free_pages == 6
    assert pool.free_count == frees_before
    pool.free([p0, p1])
    assert pool.refcount(p0) == 0 and pool.free_pages == 8
    with pytest.raises(ValueError, match="ref of free"):
        pool.ref([p0])


def test_defrag_plan_strict_about_holders_and_keeps_refcounts():
    pool = PagePool(8, 4)
    t = pool.alloc_table(8)
    loose = pool.alloc(1)
    pool.ref([t.pages[0]])
    with pytest.raises(ValueError, match="unaccounted"):
        defrag_plan(pool, [t])
    shared_page = t.pages[0]
    mapping = defrag_plan(pool, [t], extra_pages=loose)
    assert pool.refcount(mapping[shared_page]) == 2
    assert sorted(t.pages + [mapping[loose[0]]]) == [0, 1, 2]


def _toks(*ids):
    return np.asarray(ids, np.int32)


def test_prefix_cache_lookup_insert_and_dedupe():
    pool = PagePool(16, 4)
    cache = PrefixCache(pool, budget_pages=8)
    assert cache.lookup(_toks(1, 2, 3, 4)) is None
    pages = pool.alloc(2)
    prompt = _toks(*range(8))
    assert cache.insert(prompt, pages) == 2
    m = cache.lookup(prompt)
    assert m.full and m.tokens == 8 and m.pages == pages
    pool.free(m.pages)
    m = cache.lookup(_toks(0, 1, 2, 3, 9, 9, 9))
    assert not m.full and m.tokens == 4 and m.pages == [pages[0]]
    pool.free(m.pages)
    again = pool.alloc(2)
    assert cache.insert(prompt, again) == 0
    pool.free(again)
    pool.free(pages)
    assert pool.used_pages == 2


def test_prefix_cache_lru_eviction_spares_live_pages():
    pool = PagePool(16, 2)
    cache = PrefixCache(pool, budget_pages=2)
    for base in (0, 10, 20):
        p = pool.alloc(1)
        cache.insert(_toks(base, base + 1), p)
        pool.free(p)
    assert cache.stats()["evicted_pages"] == 1
    assert cache.lookup(_toks(0, 1)) is None
    m = cache.lookup(_toks(20, 21))
    for base in (30, 40):
        p = pool.alloc(1)
        cache.insert(_toks(base, base + 1), p)
        pool.free(p)
    m2 = cache.lookup(_toks(20, 21))
    assert m2 is not None
    pool.free(m.pages)
    pool.free(m2.pages)
    assert cache.reclaim(2) == 2 and pool.used_pages == 0


def test_prefix_cache_remap_follows_defrag():
    pool = PagePool(8, 4)
    junk = pool.alloc(2)
    run = pool.alloc(2)
    cache = PrefixCache(pool, budget_pages=4)
    prompt = _toks(*range(8))
    cache.insert(prompt, run)
    pool.free(run)
    pool.free(junk)
    mapping = defrag_plan(pool, [], extra_pages=cache.pages())
    cache.remap(mapping)
    m = cache.lookup(prompt)
    assert m.pages == [mapping[p] for p in run] == [0, 1]
    pool.free(m.pages)


# ---------------------------------------------------------------------------
# decode model vs the JAX package
# ---------------------------------------------------------------------------

def test_init_gpt_params_bit_identical_to_jax():
    cfg = pgpt.GPTConfig(**SIZE)
    mine = pgpt.init_gpt_params(cfg, seed=3)
    ref = jgpt.init_gpt_params(jgpt.GPTConfig(**SIZE), seed=3)
    assert set(mine) == set(ref) and set(mine["blocks"]) == set(ref["blocks"])
    for k in ("wte", "wpe", "lnf_s", "lnf_b"):
        np.testing.assert_array_equal(mine[k], ref[k])
    for k, v in ref["blocks"].items():
        np.testing.assert_array_equal(mine["blocks"][k], v)


def test_params_from_jax_keeps_layout(models):
    _, jm, cfg, pm = models
    for l, blk in enumerate(pm.params["blocks"]):
        for k, v in blk.items():
            np.testing.assert_array_equal(
                v.numpy(), np.asarray(jm.params["blocks"][k][l]))
            assert v.is_contiguous()
    assert tuple(pm.params["blocks"][0]["w_up"].shape) == (128, 512)


def test_gpt_forward_matches_jax(models):
    cfg_j, jm, cfg_p, pm = models
    ids = np.random.RandomState(1).randint(0, 512, (2, 24))
    want = np.asarray(jgpt.gpt_forward(jm.params, jnp.asarray(ids), cfg_j))
    got = pgpt.gpt_forward(pm.params, torch.from_numpy(ids), cfg_p)
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


def test_composed_and_fused_tails_agree(models):
    """cfg.fused_blocks=False (the composed chain) and the fused path's
    plain versions compute the same tail."""
    _, _, cfg_p, pm = models
    rng = np.random.RandomState(4)
    a = torch.from_numpy(rng.randn(5, 128).astype(np.float32))
    x = torch.from_numpy(rng.randn(5, 128).astype(np.float32))
    p = pm.params["blocks"][1]
    fused = pgpt.decoder_tail(p, a, x, cfg_p)
    composed = pgpt.decoder_tail(
        p, a, x, dataclasses.replace(cfg_p, fused_blocks=False))
    np.testing.assert_allclose(fused.numpy(), composed.numpy(), atol=1e-5,
                               rtol=1e-5)


@pytest.fixture(scope="module")
def model_steps(models):
    """The same prefill -> prefill_tail -> decode sequence through both
    decode models; returns each stage's (port, jax) logits + caches."""
    cfg_j, jm, cfg_p, pm = models
    ps, P, M = 8, 16, 8
    rng = np.random.RandomState(2)
    prompt = rng.randint(0, 512, (27,)).astype(np.int32)
    row = np.full((M,), P, np.int32)
    row[:5] = [3, 7, 1, 12, 5]
    out = {}
    jc, pc = jm.init_cache(P, ps), pm.init_cache(P, ps)

    # prefill of the first 11 tokens in a 16-token bucket
    toks = np.zeros((16,), np.int32)
    toks[:11] = prompt[:11]
    jc, jl = jm.prefill(jm.params, jc, jnp.asarray(toks), jnp.int32(11),
                        jnp.asarray(row))
    pc, pl = pm.prefill(pm.params, pc, torch.from_numpy(toks), 11,
                        torch.from_numpy(row))
    out["prefill"] = (pl.numpy(), np.asarray(jl),
                      pc["k"][:, row[:2]].numpy(),
                      np.asarray(jc["k"][:, row[:2]]))

    # the first 16 tokens (2 pages) as a cached prefix, tail of 11
    toks[:16] = prompt[:16]
    pre = np.zeros((16,), np.int32)
    pre[:11] = prompt[16:27]
    jc, jl = jm.prefill(jm.params, jc, jnp.asarray(toks), jnp.int32(16),
                        jnp.asarray(row))
    pc, pl = pm.prefill(pm.params, pc, torch.from_numpy(toks), 16,
                        torch.from_numpy(row))
    jc, jl = jm.prefill_tail(jm.params, jc, jnp.asarray(pre),
                             jnp.int32(16), jnp.int32(11),
                             jnp.asarray(row))
    pc, pl = pm.prefill_tail(pm.params, pc, torch.from_numpy(pre), 16, 11,
                             torch.from_numpy(row))
    out["prefill_tail"] = (pl.numpy(), np.asarray(jl),
                           pc["v"][:, row[2:4]].numpy(),
                           np.asarray(jc["v"][:, row[2:4]]))

    # one decode step: slot 0 continues the prompt at position 27, slot
    # 1 is inactive (trash row, position 0), slot 2 reuses the prefix
    tables = np.full((3, M), P, np.int32)
    tables[0] = row
    tables[2, :2] = row[:2]
    tokens = np.asarray([int(prompt[-1]), 0, int(prompt[9])], np.int32)
    positions = np.asarray([27, 0, 9], np.int32)
    jc, jl = jm.decode(jm.params, jc, jnp.asarray(tokens),
                       jnp.asarray(positions), jnp.asarray(tables))
    pc, pl = pm.decode(pm.params, pc, torch.from_numpy(tokens),
                       torch.from_numpy(positions), torch.from_numpy(tables))
    out["decode"] = (pl.numpy()[[0, 2]], np.asarray(jl)[[0, 2]],
                     pc["k"].numpy(), np.asarray(jc["k"]))
    return out


@pytest.mark.parametrize("stage", ["prefill", "prefill_tail", "decode"])
def test_decode_model_stage_matches_jax(model_steps, stage):
    got, want, cache_got, cache_want = model_steps[stage]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    # K/V written into the pages (trash page excluded: it takes writes
    # from every padded position in an unspecified order)
    np.testing.assert_allclose(cache_got[:, :-1] if stage == "decode"
                               else cache_got,
                               cache_want[:, :-1] if stage == "decode"
                               else cache_want, atol=1e-5, rtol=1e-5)


def test_cache_updates_are_in_place(models):
    _, _, _, pm = models
    cache = pm.init_cache(8, 8)
    k_ptr = cache["k"].data_ptr()
    toks = torch.arange(8, dtype=torch.int32)
    row = torch.tensor([2, 8, 8, 8], dtype=torch.int32)
    cache2, _ = pm.prefill(pm.params, cache, toks, 8, row)
    assert cache2 is cache and cache["k"].data_ptr() == k_ptr
    assert float(cache["k"][:, 2].abs().sum()) > 0
    assert float(cache["k"][:, :2].abs().sum()) == 0
    pm.copy_pages(cache, [2], [5])
    assert torch.equal(cache["k"][:, 5], cache["k"][:, 2])


# ---------------------------------------------------------------------------
# engine end to end vs the JAX engine
# ---------------------------------------------------------------------------

def _jobs(seed=3, sampled=False, n=6):
    """Shared 16-token (2-page) prefix + unique tails, a duplicate
    prompt (the full-prompt bootstrap path), one unrelated prompt."""
    rng = np.random.RandomState(seed)
    shared = rng.randint(0, 512, (16,))
    jobs = []
    for i in range(n):
        tail = rng.randint(0, 512, (int(rng.randint(1, 12)),))
        kw = dict(temperature=0.8, top_k=12, top_p=0.9, seed=500 + i) \
            if sampled else {}
        jobs.append((np.concatenate([shared, tail]),
                     int(rng.randint(2, 9)), kw))
    kw = dict(temperature=0.9, top_k=0, top_p=0.95,
              seed=2 ** 63 + 5) if sampled else {}
    jobs.append((shared.copy(), 6, kw))
    jobs.append((shared.copy(), 6, dict(kw)))
    jobs.append((rng.randint(0, 512, (5,)), 7, {}))
    return jobs


def _run_all(eng, jobs, sequential=False):
    if sequential:
        return [_run_all(eng, [j])[0] for j in jobs]
    hs = [eng.submit(p, mnt, **kw) for p, mnt, kw in jobs]
    eng.run_until_idle()
    return [h.result(1.0).tolist() for h in hs]


def _assert_greedy_parity(models, jobs, got, want):
    """Tokens equal; a difference is allowed only where the JAX model's
    top-2 logits are within TIE_TOL at the first differing position."""
    cfg_j, jm, _, _ = models
    for (prompt, _, kw), g, w in zip(jobs, got, want):
        assert not kw, "greedy jobs only"
        if g == w:
            continue
        i = next(k for k in range(len(w)) if k >= len(g) or g[k] != w[k])
        ids = np.concatenate([prompt, w[:i]]).astype(np.int32)[None]
        logits = np.asarray(jgpt.gpt_forward(jm.params, jnp.asarray(ids),
                                             cfg_j))[0, -1]
        top2 = np.sort(logits)[-2:]
        assert top2[1] - top2[0] < TIE_TOL, (prompt, g, w, top2)


@pytest.fixture(scope="module")
def jax_greedy(models):
    _, jm, _, _ = models
    return _run_all(JEngine(jm, **ENGINE_KW), _jobs())


def test_engine_greedy_matches_jax_engine(models, jax_greedy):
    pm = models[3]
    eng = Engine(pm, **ENGINE_KW)
    got = _run_all(eng, _jobs())
    _assert_greedy_parity(models, _jobs(), got, jax_greedy)
    st = eng.stats()
    assert st["compiles"] and all(v == 1 for v in st["compiles"].values())
    assert sum(1 for k in st["compiles"] if k.startswith("decode")) == 1
    assert st["pool"]["used_pages"] == 0 and st["completed"] == len(got)


def test_engine_prefix_cache_on_equals_off_and_jax(models, jax_greedy):
    pm = models[3]
    on = Engine(pm, **ENGINE_KW, prefix_cache_pages=32)
    first = _run_all(on, _jobs(), sequential=True)   # miss, hit, bootstrap
    _assert_greedy_parity(models, _jobs(), first, jax_greedy)
    st = on.stats()["prefix_cache"]
    assert st["hits"] >= 2 and st["tokens_saved"] >= 16
    assert st["cow_copies"] >= 1
    assert any(k.startswith("prefill_tail") for k in on.stats()["compiles"])
    assert _run_all(on, _jobs()) == first               # warm, concurrent
    off = Engine(pm, **ENGINE_KW)
    assert _run_all(off, _jobs()) == first
    assert on.pool.used_pages == on.stats()["prefix_cache"]["cached_pages"]


def test_engine_seeded_sampling_matches_jax_engine(models):
    _, jm, _, pm = models
    jobs = _jobs(seed=5, sampled=True)
    want = _run_all(JEngine(jm, **ENGINE_KW), jobs)
    got = _run_all(Engine(pm, **ENGINE_KW), jobs)
    assert got == want
    on = Engine(pm, **ENGINE_KW, prefix_cache_pages=32)
    assert _run_all(on, jobs, sequential=True) == want
    assert want[-3] == want[-2]          # same prompt + seed replays


def _greedy_ref(pm, cfg, prompt, n):
    ids = list(int(t) for t in prompt)
    out = []
    for _ in range(n):
        logits = pgpt.gpt_forward(pm.params, torch.tensor([ids]), cfg)
        out.append(int(torch.argmax(logits[0, -1])))
        ids.append(out[-1])
    return out


def test_engine_default_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default is valid here")
    cfg = pgpt.GPTConfig(**SIZE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(GPTDecodeModel(cfg))
    with pytest.raises(RuntimeError, match="CUDA"):
        GPTDecodeModel(cfg, device="cuda")


def test_engine_deadline_preemption_returns_pages(models):
    pm = models[3]
    eng = Engine(pm, **ENGINE_KW)
    long_req = eng.submit(np.arange(8), 40, deadline=3600.0)
    short = eng.submit(np.arange(4) + 9, 4)
    for _ in range(4):
        eng.step()
    assert long_req.status == "running" and len(long_req.generated) >= 1
    long_req.deadline = -1.0
    eng.run_until_idle()
    assert long_req.status == "deadline" and len(long_req.result()) >= 1
    assert short.status == "done"
    assert eng.pool.used_pages == 0 and eng.stats()["preemptions"] == 1


def test_engine_poison_request_fails_alone(models):
    pm = models[3]
    eng = Engine(pm, **ENGINE_KW)
    orig = eng._prefill

    def boom(*a, **k):
        raise RuntimeError("poison prompt")

    eng._prefill = boom
    bad = eng.submit([1, 2, 3], 4)
    eng.step()
    assert bad.status == "error"
    with pytest.raises(RuntimeError, match="poison"):
        bad.result(1.0)
    eng._prefill = orig
    assert eng.pool.used_pages == 0
    good = eng.submit([4, 5], 3)
    eng.run_until_idle()
    assert good.status == "done" and len(good.result()) == 3


def test_engine_cancel_and_defrag_midflight_keep_parity(models):
    _, _, cfg, pm = models
    eng = Engine(pm, **ENGINE_KW)
    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, 512, (int(rng.randint(2, 20)),))
               for _ in range(3)]
    victim = eng.submit([2, 4, 6], 32)
    handles = [eng.submit(p, 6) for p in prompts]
    for _ in range(3):
        eng.step()
    assert eng.cancel(victim) and victim.status == "cancelled"
    mapping = eng.defrag()
    live = sorted(p for r in eng.scheduler.active_requests()
                  for p in r.table.pages)
    assert live == list(range(len(live))) and isinstance(mapping, dict)
    eng.run_until_idle()
    for p, h in zip(prompts, handles):
        assert h.result().tolist() == _greedy_ref(pm, cfg, p, 6)
    assert eng.pool.used_pages == 0


def test_engine_caps_sequence_at_model_positions(models):
    pm = models[3]
    eng = Engine(pm, num_slots=2, num_pages=64, page_size=8)
    assert eng.max_seq_len == 128
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.submit([1] * 100, 40)


def test_engine_threaded_generate_and_stats(models):
    pm = models[3]
    eng = Engine(pm, **ENGINE_KW)
    with eng:
        toks = eng.generate([2, 7, 1], max_new_tokens=5, timeout=60)
        assert len(toks) == 5
    st = eng.stats()
    assert st["tokens_generated"] == 5 and st["mfu"] == 0.0
    assert eng._thread is None
    assert eng._kv_cache_bytes() == 2 * 2 * 65 * 8 * 128 * 4

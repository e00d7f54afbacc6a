"""Production traffic harness: open-loop load generation + SLO report
(counterpart of ``paddle_tpu/serving/loadgen.py``: the same schedule,
arrival for arrival, for the same ``TrafficConfig``).

A closed-loop client (submit, wait, submit) can never expose queueing
collapse, because a slow server slows its own offered load. This
module is the open-loop replayer: arrivals fire on a precomputed
schedule whether or not earlier requests finished, the way traffic from
millions of independent users does.

Design rules:

  * deterministic — every arrival time, prompt length, output length,
    tenant, tier and prompt token comes from a counter-based Philox
    stream keyed by ``TrafficConfig.seed``; two generators with the
    same config produce byte-identical schedules (no wall-clock
    randomness, so chaos tests can replay the exact same traffic
    around an injected fault);
  * open loop — `run` submits on schedule and NEVER waits for
    completions; backpressure shows up as rejected/shed counts in the
    report, not as a silenced arrival process;
  * arrival processes — `constant`, `diurnal` (sinusoidal rate
    modulation, a day compressed into `diurnal_period` seconds) and
    `bursty` (square-wave on/off bursts), all realised by thinning a
    homogeneous Poisson stream at the peak rate;
  * tagged requests — tenant, priority tier and per-tier relative
    deadline ride each request into the scheduler's admission control
    (priority aging, token-bucket quotas, shed-by-priority);
  * SLOs are first-class — `slo_report` turns the finished handles
    into p50/p99 TTFT, p99 inter-token latency, deadline attainment
    and goodput (tokens from requests that met their deadline), and
    mirrors them onto ``paddle_tpu_slo_*`` registry metrics so a
    scrape sees the same numbers the bench JSON reports.

No torch here: the generator drives an Engine (in-process), a
ServingClient (wire) or any submit callable, and is unit-testable
against a bare Scheduler.
"""
from __future__ import annotations

import itertools
import math
import threading
import time
import weakref

import numpy as np

from ..observability import registry as _obs
from .scheduler import QueueFull

__all__ = ["TrafficConfig", "Arrival", "LoadGenerator", "LoadResult",
           "slo_report"]

# SLO surface: the load generator writes what it
# measured, labeled per generator run, so `/metrics` exposes the same
# attainment/goodput numbers the bench JSON rows carry
_TTFT_H = _obs.histogram(
    "paddle_tpu_slo_ttft_seconds",
    "submit-to-first-token latency of generated traffic", ["gen"])
_ITL_H = _obs.histogram(
    "paddle_tpu_slo_inter_token_seconds",
    "mean inter-token latency per finished request", ["gen"])
_MET = _obs.counter(
    "paddle_tpu_slo_deadline_met_total",
    "generated requests that completed within their deadline", ["gen"])
_MISSED = _obs.counter(
    "paddle_tpu_slo_deadline_missed_total",
    "generated requests that expired, were preempted, shed, rejected "
    "or errored", ["gen"])
_GOODPUT = _obs.counter(
    "paddle_tpu_slo_goodput_tokens_total",
    "tokens from requests that met their deadline", ["gen"])
_ATTAIN = _obs.gauge(
    "paddle_tpu_slo_attainment_ratio",
    "met requests / offered requests for the latest report", ["gen"])

_gen_ids = itertools.count()


def _drop_gen_series(gen: str):
    for m in (_TTFT_H, _ITL_H, _MET, _MISSED, _GOODPUT, _ATTAIN):
        m.remove_matching(gen=gen)


def _weighted(rng: np.random.Generator, choices):
    """choices: dict value -> weight (or list of (value, weight))."""
    items = list(choices.items()) if isinstance(choices, dict) \
        else list(choices)
    vals = [v for v, _ in items]
    w = np.asarray([float(p) for _, p in items], np.float64)
    return vals[int(rng.choice(len(vals), p=w / w.sum()))]


class TrafficConfig:
    """One traffic mix. All rates are requests/sec of OFFERED load."""

    def __init__(self, rate: float = 20.0, duration: float = 5.0,
                 arrival: str = "constant",
                 diurnal_period: float = 10.0,
                 diurnal_depth: float = 0.8,
                 burst_period: float = 2.0, burst_fraction: float = 0.25,
                 burst_factor: float = 4.0,
                 prompt_lens=None, output_lens=None,
                 tenants=None, tiers=None, deadlines=None,
                 vocab_size: int = 256, seed: int = 0,
                 prefix_pool: int = 0, prefix_len: int = 0,
                 prefix_zipf: float = 1.1,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0):
        if arrival not in ("constant", "diurnal", "bursty"):
            raise ValueError(f"unknown arrival process {arrival!r}")
        if not 0.0 <= diurnal_depth < 1.0:
            raise ValueError("diurnal_depth must be in [0, 1)")
        self.rate = float(rate)
        self.duration = float(duration)
        self.arrival = arrival
        self.diurnal_period = float(diurnal_period)
        self.diurnal_depth = float(diurnal_depth)
        self.burst_period = float(burst_period)
        self.burst_fraction = float(burst_fraction)
        self.burst_factor = float(burst_factor)
        # mixed-length traffic (Ragged Paged Attention regime): short
        # chat turns next to long-context prompts, short and long
        # generations interleaved
        self.prompt_lens = prompt_lens or {4: 4, 8: 3, 16: 2, 32: 1}
        self.output_lens = output_lens or {2: 3, 4: 3, 8: 2, 16: 1}
        self.tenants = tenants or {"default": 1}
        self.tiers = tiers or {0: 1, 1: 2, 2: 1}
        # per-tier RELATIVE deadline seconds (None = unbounded)
        self.deadlines = deadlines if deadlines is not None \
            else {0: 30.0, 1: 60.0, 2: None}
        self.vocab_size = int(vocab_size)
        self.seed = int(seed)
        # shared-prefix traffic: each arrival prepends a
        # zipf-popular system prompt from a pool of `prefix_pool`
        # fixed prefixes of `prefix_len` tokens, then its own unique
        # suffix — the fleet-shaped workload the radix prefix cache
        # exists for. 0/0 (the default) leaves every existing config's
        # schedule byte-identical.
        self.prefix_pool = int(prefix_pool)
        self.prefix_len = int(prefix_len)
        self.prefix_zipf = float(prefix_zipf)
        if self.prefix_pool < 0 or self.prefix_len < 0:
            raise ValueError("prefix_pool/prefix_len must be >= 0")
        if self.prefix_zipf <= 0:
            raise ValueError("prefix_zipf must be > 0")
        # stochastic decode knobs stamped onto every arrival
        # (serving/sampling.py validates the same ranges server-side)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        if self.temperature < 0:
            raise ValueError("temperature must be >= 0")

    # -- time-varying offered rate --------------------------------------
    def rate_at(self, t: float) -> float:
        if self.arrival == "diurnal":
            return self.rate * (1.0 + self.diurnal_depth * math.sin(
                2.0 * math.pi * t / self.diurnal_period))
        if self.arrival == "bursty":
            frac = (t % self.burst_period) / self.burst_period
            return self.rate * self.burst_factor \
                if frac < self.burst_fraction else self.rate
        return self.rate

    @property
    def peak_rate(self) -> float:
        if self.arrival == "diurnal":
            return self.rate * (1.0 + self.diurnal_depth)
        if self.arrival == "bursty":
            return self.rate * self.burst_factor
        return self.rate


class Arrival:
    """One scheduled request: offset seconds from run start + tags."""

    __slots__ = ("index", "t", "prompt", "max_new_tokens", "tenant",
                 "tier", "deadline", "temperature", "top_k", "top_p",
                 "seed")

    def __init__(self, index, t, prompt, max_new_tokens, tenant, tier,
                 deadline, temperature=0.0, top_k=0, top_p=1.0,
                 seed=None):
        self.index = index
        self.t = t
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.tenant = tenant
        self.tier = tier
        self.deadline = deadline
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        # per-arrival seed (from the per-index Philox stream): the
        # whole point is that a same-config rerun resubmits the SAME
        # seed, so stochastic decode replays token-for-token
        self.seed = seed

    def __repr__(self):
        return (f"Arrival({self.index}, t={self.t:.4f}, "
                f"plen={len(self.prompt)}, mnt={self.max_new_tokens}, "
                f"tenant={self.tenant!r}, tier={self.tier}, "
                f"deadline={self.deadline})")


class LoadResult:
    """What a run produced: (arrival, handle) pairs for submitted
    requests plus the arrivals the scheduler turned away at submit."""

    def __init__(self, name: str, started_at: float, elapsed: float):
        self.name = name
        self.started_at = started_at
        self.elapsed = elapsed
        self.handles: list[tuple[Arrival, object]] = []
        self.rejected: list[Arrival] = []
        # gen labels slo_report already mirrored to the registry for
        # this result: re-reporting (full run, then a window slice)
        # must not double-count the paddle_tpu_slo_* series
        self._mirrored: set[str] = set()

    @property
    def offered(self) -> int:
        return len(self.handles) + len(self.rejected)

    def wait(self, timeout: float = 120.0) -> bool:
        """Block until every submitted request finished (including
        shed/preempted — anything that set its done event)."""
        deadline = time.monotonic() + timeout
        for _, h in self.handles:
            if not h.wait(max(0.0, deadline - time.monotonic())):
                return False
        return True


class LoadGenerator:
    """Deterministic open-loop replayer for one TrafficConfig."""

    def __init__(self, cfg: TrafficConfig, name: str | None = None):
        self.cfg = cfg
        self.name = name if name is not None else f"g{next(_gen_ids)}"
        # a dead generator's series leave the exposition
        weakref.finalize(self, _drop_gen_series, self.name)

    # -- schedule (pure, deterministic) ---------------------------------
    def schedule(self) -> list[Arrival]:
        """The full arrival list for this config — counter-based Philox
        streams only, so the same seed replays byte-identically."""
        cfg = self.cfg
        rng = np.random.Generator(np.random.Philox(key=cfg.seed))
        lam = cfg.peak_rate
        # shared system-prompt pool: its own key word ((1<<64)-1 can
        # never collide with a per-index stream), zipf-ranked weights
        # (entry 0 most popular) drawn per arrival from the main stream
        pool: list[np.ndarray] = []
        pool_w = None
        if cfg.prefix_pool > 0 and cfg.prefix_len > 0:
            prng0 = np.random.Generator(np.random.Philox(
                key=np.array([cfg.seed, (1 << 64) - 1], np.uint64)))
            pool = [prng0.integers(0, cfg.vocab_size,
                                   size=cfg.prefix_len,
                                   dtype=np.int64).astype(np.int32)
                    for _ in range(cfg.prefix_pool)]
            pool_w = 1.0 / np.arange(
                1, cfg.prefix_pool + 1) ** cfg.prefix_zipf
            pool_w = pool_w / pool_w.sum()
        out: list[Arrival] = []
        t = 0.0
        i = 0
        while True:
            t += float(rng.exponential(1.0 / lam))
            if t >= cfg.duration:
                break
            # thinning: keep the candidate with prob rate(t)/peak
            if float(rng.random()) > cfg.rate_at(t) / lam:
                continue
            plen = int(_weighted(rng, cfg.prompt_lens))
            mnt = int(_weighted(rng, cfg.output_lens))
            tenant = str(_weighted(rng, cfg.tenants))
            tier = int(_weighted(rng, cfg.tiers))
            deadline = cfg.deadlines.get(tier)
            # prompt tokens from a stream keyed by (seed, index): the
            # i-th request's content does not depend on how many
            # earlier candidates the thinning pass dropped
            prng = np.random.Generator(np.random.Philox(
                key=(cfg.seed, i)))
            prompt = prng.integers(0, cfg.vocab_size, size=plen,
                                   dtype=np.int64).astype(np.int32)
            if pool:
                # zipf-popular shared head + this request's unique
                # suffix (the suffix is the plen draw above, so prompt
                # content without a pool is unchanged byte-for-byte)
                j = int(rng.choice(len(pool), p=pool_w))
                prompt = np.concatenate([pool[j], prompt])
            seed = None
            if cfg.temperature > 0:
                # per-index stream again: the i-th arrival's seed never
                # depends on thinning, so a rerun replays it exactly
                seed = int(prng.integers(0, 1 << 62))
            out.append(Arrival(i, t, prompt, mnt, tenant, tier,
                               deadline, temperature=cfg.temperature,
                               top_k=cfg.top_k, top_p=cfg.top_p,
                               seed=seed))
            i += 1
        return out

    # -- execution ------------------------------------------------------
    def run(self, submit, *, now=time.monotonic, sleep=time.sleep,
            stop: threading.Event | None = None) -> LoadResult:
        """Open-loop replay: call ``submit(arrival)`` at each scheduled
        offset (late submits fire immediately — the generator never
        skips offered load). `submit` returns a handle with
        ``wait(timeout)`` (e.g. scheduler.Request) or None for
        fire-and-forget transports; QueueFull/QuotaExceeded count as
        rejected offered load, and so does a ValueError from an
        arrival the target cannot serve (prompt+max_new over the
        engine's max_seq_len) — one oversized arrival must not abort
        the replay, or the same-arrivals baseline/faulted comparison
        breaks. `stop` aborts the replay early."""
        t0 = now()
        res = LoadResult(self.name, t0, 0.0)
        for arr in self.schedule():
            if stop is not None and stop.is_set():
                break
            delay = (t0 + arr.t) - now()
            if delay > 0:
                sleep(delay)
            try:
                h = submit(arr)
            except (QueueFull, ValueError):
                res.rejected.append(arr)
                continue
            if h is not None:
                res.handles.append((arr, h))
        res.elapsed = now() - t0
        return res

    def run_engine(self, engine, **kw) -> LoadResult:
        """Replay against a serving Engine in-process."""
        def submit(arr: Arrival):
            return engine.submit(arr.prompt, arr.max_new_tokens,
                                 deadline=arr.deadline,
                                 priority=arr.tier, tenant=arr.tenant,
                                 temperature=arr.temperature,
                                 top_k=arr.top_k, top_p=arr.top_p,
                                 seed=arr.seed)
        return self.run(submit, **kw)

    def run_client(self, client, timeout: float = 120.0,
                   stream: bool = True, **kw) -> LoadResult:
        """Replay over the wire (serving/frontend.py ServingClient).
        The blocking `generate` calls run on their own threads so the
        arrival process stays open-loop; over the multiplexed
        transport those threads genuinely share
        ONE client's pooled channels — concurrent calls interleave by
        request id on the same sockets instead of each opening a
        connection, so wire TTFT measures the server, not
        head-of-line queueing in the client. Each handle
        mimics Request enough for slo_report
        (wait/status/generated/deadline...). With ``stream=True`` (the
        default) each call rides the streaming wire generate: token
        frames stamp first/last-token times as they ARRIVE, so
        slo_report over a wire run carries real end-to-end TTFT and
        inter-token percentiles — including every network hop, which
        the in-process run_engine numbers can never see.
        ``stream=False`` restores the one-shot wire call (attainment +
        goodput only, ttft/itl percentiles None)."""
        threads: list[threading.Thread] = []

        class _WireHandle:
            def __init__(self, arr: Arrival, submitted_at: float):
                self.status = "pending"
                self.generated: list[int] = []
                self.trace_id = None
                self.deadline = None if arr.deadline is None \
                    else submitted_at + arr.deadline
                self._queued_at = submitted_at
                self.submitted_at = submitted_at
                self.finished_at = None
                self.first_token_at = None
                self.last_token_at = None
                self._streamed = 0
                self._done = threading.Event()

            def wait(self, t=None):
                return self._done.wait(t)

            def on_tokens(self, toks, idx):
                # ARRIVAL time of a pushed frame — the wire-true SLO
                # clock (includes queueing, prefill, network)
                t = time.monotonic()
                if self.first_token_at is None:
                    self.first_token_at = t
                self.last_token_at = t
                self._streamed = max(self._streamed, idx + len(toks))

            def ttft(self):
                if self.first_token_at is None:
                    return None
                return self.first_token_at - self._queued_at

            def inter_token(self):
                if self.first_token_at is None \
                        or self.last_token_at is None \
                        or self._streamed < 2:
                    return None
                return (self.last_token_at - self.first_token_at) \
                    / (self._streamed - 1)

        def submit(arr: Arrival):
            h = _WireHandle(arr, time.monotonic())

            def call():
                try:
                    rep = client.generate(
                        arr.prompt, arr.max_new_tokens,
                        deadline=arr.deadline, timeout=timeout,
                        priority=arr.tier, tenant=arr.tenant,
                        stream=stream,
                        on_token=h.on_tokens if stream else None,
                        temperature=arr.temperature, top_k=arr.top_k,
                        top_p=arr.top_p, seed=arr.seed)
                    h.status = rep.get("status", "error")
                    h.trace_id = rep.get("trace_id")
                    h.generated = list(np.asarray(
                        rep.get("tokens", ())).ravel())
                except Exception:
                    h.status = "error"
                h.finished_at = time.monotonic()
                h._done.set()

            th = threading.Thread(target=call, daemon=True)
            th.start()
            threads.append(th)
            return h

        res = self.run(submit, **kw)
        for th in threads:
            th.join(timeout)
        return res


def _pct(sorted_vals: list[float], p: float) -> float | None:
    """Nearest-rank percentile: the smallest value with at least p% of
    the samples at or below it (p50 of [a, b] is a, not b)."""
    if not sorted_vals:
        return None
    i = max(0, math.ceil(p / 100.0 * len(sorted_vals)) - 1)
    return sorted_vals[min(len(sorted_vals) - 1, i)]


def _pct_exemplar(sorted_pairs: list, p: float):
    """Trace id of the nearest-rank percentile sample — the request
    that IS the reported p99, so an SLO regression links straight to
    one request's trace instead of a number."""
    if not sorted_pairs:
        return None
    i = max(0, math.ceil(p / 100.0 * len(sorted_pairs)) - 1)
    return sorted_pairs[min(len(sorted_pairs) - 1, i)][1]


def slo_report(result: LoadResult, window: tuple | None = None,
               gen: str | None = None) -> dict:
    """SLO attainment over a LoadResult (call after `result.wait()`).

    A request MEETS its SLO when it finished with status "done" within
    its deadline (unbounded requests just need "done"); expired,
    preempted, shed, rejected and errored requests miss. Goodput counts
    only tokens from requests that met. `window=(lo, hi)` restricts the
    report to arrivals with lo <= arr.t < hi — how the chaos drills
    compare pre-fault / post-recovery slices of one run; rates
    (goodput_tokens_per_sec) are then per second of the WINDOW, not of
    the whole run.
    """
    gen = gen if gen is not None else result.name
    pairs = result.handles
    rejected = list(result.rejected)
    span = max(result.elapsed, 1e-9)
    if window is not None:
        lo, hi = window
        pairs = [(a, h) for a, h in pairs if lo <= a.t < hi]
        rejected = [a for a in rejected if lo <= a.t < hi]
        # rates are per second OF THE WINDOW, not of the whole run —
        # a post-recovery slice must not be diluted by pre-fault time
        span = max(min(hi, result.elapsed) - max(lo, 0.0), 1e-9)
    # mirror to the registry once per (result, gen): the docs idiom —
    # slo_report(res) then slo_report(res, window=...) — must not
    # double-count the scrape surface. Custom gen labels have no
    # LoadGenerator finalizer, so their series lifetime is tied to the
    # RESULT they were mirrored through (no unbounded exposition from
    # periodic windowed reports with unique labels).
    mirror = gen not in result._mirrored
    result._mirrored.add(gen)
    if mirror:
        weakref.finalize(result, _drop_gen_series, gen)
    ttfts: list[tuple] = []     # (seconds, trace id or None)
    itls: list[tuple] = []
    met = 0
    good_tokens = 0
    by_status: dict[str, int] = {}
    for arr, h in pairs:
        by_status[h.status] = by_status.get(h.status, 0) + 1
        # engine Requests carry .trace_id natively; wire handles learn
        # theirs from the generate reply — either way the histogram
        # observation carries the exemplar so a bucket links back to
        # one request's trace
        tid = getattr(h, "trace_id", None)
        tt = h.ttft()
        if tt is not None:
            ttfts.append((tt, tid))
            if mirror:
                _TTFT_H.labels(gen=gen).observe(tt, trace_id=tid)
        itl = h.inter_token()
        if itl is not None:
            itls.append((itl, tid))
            if mirror:
                _ITL_H.labels(gen=gen).observe(itl, trace_id=tid)
        ok = h.status == "done" and (
            h.deadline is None or h.finished_at is None
            or h.finished_at <= h.deadline)
        if ok:
            met += 1
            good_tokens += len(h.generated)
        if mirror:
            (_MET if ok else _MISSED).labels(gen=gen).inc()
    if mirror:
        _MISSED.labels(gen=gen).inc(len(rejected))
    by_status["rejected"] = by_status.get("rejected", 0) + len(rejected)
    offered = len(pairs) + len(rejected)
    attainment = met / offered if offered else None
    if mirror:
        if attainment is not None:
            _ATTAIN.labels(gen=gen).set(attainment)
        _GOODPUT.labels(gen=gen).inc(good_tokens)
    ttfts.sort(key=lambda p: p[0])
    itls.sort(key=lambda p: p[0])
    tt_vals = [v for v, _ in ttfts]
    itl_vals = [v for v, _ in itls]
    return {
        "offered": offered,
        "met": met,
        "attainment": round(attainment, 4) if attainment is not None
        else None,
        "goodput_tokens_per_sec": round(good_tokens / span, 2),
        "goodput_tokens": good_tokens,
        "ttft_ms_p50": None if not tt_vals
        else round(_pct(tt_vals, 50) * 1e3, 3),
        "ttft_ms_p99": None if not tt_vals
        else round(_pct(tt_vals, 99) * 1e3, 3),
        "ttft_p99_trace": _pct_exemplar(ttfts, 99),
        "itl_ms_p50": None if not itl_vals
        else round(_pct(itl_vals, 50) * 1e3, 3),
        "itl_ms_p99": None if not itl_vals
        else round(_pct(itl_vals, 99) * 1e3, 3),
        "itl_p99_trace": _pct_exemplar(itls, 99),
        "by_status": by_status,
        "elapsed_s": round(result.elapsed, 3),
    }

"""Live terminal fleet dashboard over the telemetry collector.

(counterpart of ``paddle_tpu/observability/top.py``: the same panes,
byte for byte, over the same collector replies.)

``python -m paddle_tpu_torch.observability.top --collector host:port``
renders the fleet every interval: one row per process (role,
liveness, rps, p50/p99 TTFT/ITL, queue depth, page occupancy, agent
drop counts), the tail-sampling counters, and the most recent
watchdog/bundle events with their bundle paths — the
"start from the dashboard" entry point of a postmortem.

``python -m paddle_tpu_torch.observability.top trace <id>`` prints the
assembled cross-process waterfall for one trace id and, with
``--out f.json``, exports it as ONE merged Chrome trace with
per-rank pid labels (Perfetto / chrome://tracing).

``python -m paddle_tpu_torch.observability.top perf`` renders the perf
pane: per-role MFU, the last sampled step breakdown, compile counts,
device-memory / KV headroom, and per-kernel autobench margins where a
process reports them (the port runs no autobench yet, so its processes
report none and the pane shows no margins).

``... top history <metric>`` renders per-series unicode sparklines
from the collector's TSDB (`tsdb_query` range); ``... top alerts``
the alert pane (firing/pending + recent transitions); ``... top
tenants`` the per-tenant usage pane (`usage_report`).

Rendering is pure (``render_fleet`` / ``render_waterfall`` /
``render_perf`` / ``render_history`` / ``render_alerts`` /
``render_tenants`` take the collector reply dicts), so tests drive
them without a terminal.
"""
from __future__ import annotations

import json
import os
import sys
import time

__all__ = ["render_alerts", "render_fleet", "render_history",
           "render_perf", "render_tenants", "render_tier",
           "render_waterfall", "sparkline", "main"]


def _f(v, spec="7.1f", dash="      -") -> str:
    if v is None:
        return dash
    try:
        return format(float(v), spec)
    except (TypeError, ValueError):
        return dash


def _ms(v) -> str:
    return "-" if v is None else f"{float(v) * 1000:.1f}ms"


def render_fleet(fleet: dict) -> str:
    """One screen of fleet state from a ``tel_fleet`` reply."""
    lines = []
    t = fleet.get("time") or time.time()
    tr = fleet.get("traces") or {}
    lines.append(
        f"paddle-tpu fleet  {time.strftime('%H:%M:%S', time.localtime(t))}"
        f"  procs={len(fleet.get('procs') or ())}"
        f"  open={fleet.get('open_traces', 0)}"
        f"  kept={fleet.get('kept_traces', 0)}")
    lines.append(
        "traces: assembled=%d kept(err=%d slow=%d sampled=%d) "
        "sampled_out=%d evicted=%d" % (
            tr.get("assembled", 0), tr.get("kept_error", 0),
            tr.get("kept_slow", 0), tr.get("kept_sampled", 0),
            tr.get("sampled_out", 0), tr.get("evicted", 0)))
    lines.append("")
    lines.append(f"{'ROLE':<16} {'HOST:PID':<22} {'AGE':>5} {'RPS':>7} "
                 f"{'TTFT p50/p99':>15} {'ITL p50/p99':>15} "
                 f"{'QUEUE':>6} {'OCC':>5} {'DROPS':>6}")
    for p in fleet.get("procs") or ():
        s = p.get("summary") or {}
        drops = sum((p.get("dropped") or {}).values())
        ttft = f"{_ms(s.get('ttft_p50'))}/{_ms(s.get('ttft_p99'))}" \
            if "ttft_p50" in s else \
            (f"{_ms(s.get('latency_p50'))}/{_ms(s.get('latency_p99'))}"
             if "latency_p50" in s else "-")
        itl = f"{_ms(s.get('itl_p50'))}/{_ms(s.get('itl_p99'))}" \
            if "itl_p50" in s else "-"
        lines.append(
            f"{str(p.get('role'))[:16]:<16} "
            f"{p.get('host')}:{p.get('pid'):<10} "
            f"{_f(p.get('age_s'), '5.1f', '    -')} "
            f"{_f(s.get('rps'), '7.1f')} "
            f"{ttft:>15} {itl:>15} "
            f"{_f(s.get('queue_depth'), '6.0f', '     -')} "
            f"{_f(s.get('page_occupancy'), '5.2f', '    -')} "
            f"{drops:>6d}")
    events = fleet.get("recent_events") or ()
    if events:
        lines.append("")
        lines.append("recent events:")
        for ev in list(events)[-8:]:
            at = ev.get("attrs") or {}
            extra = " ".join(f"{k}={v}" for k, v in sorted(at.items()))
            w = ev.get("wall")
            stamp = time.strftime("%H:%M:%S", time.localtime(w)) \
                if w else "--:--:--"
            lines.append(f"  {stamp} {ev.get('role')}@{ev.get('host')}"
                         f":{ev.get('pid')} {ev.get('kind')} {extra}")
    return "\n".join(lines)


def _gb(v) -> str:
    return "-" if not v else f"{float(v) / 2**30:.2f}G"


def render_perf(fleet: dict) -> str:
    """The perf pane of a ``tel_fleet`` reply: per-role MFU + step
    breakdown, compile counts, HBM/KV bytes, per-kernel margins."""
    lines = [f"{'ROLE':<16} {'HOST:PID':<22} {'MFU':>7} {'COMPILES':>9} "
             f"{'HBM used/limit':>16} {'KV':>8}  STEP BREAKDOWN (sampled)"]
    kernel_ms: dict[str, float] = {}
    any_perf = False
    for p in fleet.get("procs") or ():
        perf = (p.get("summary") or {}).get("perf") or {}
        if not perf:
            continue
        any_perf = True
        mfu = perf.get("mfu") or {}
        hbm = perf.get("hbm") or {}
        # one row per instrumented loop (engine:eN / executor), the
        # process-level columns repeated on the first row only
        loops = sorted(set(mfu)
                       | {k.split("/")[0]
                          for k in (perf.get("breakdown") or {})}) or ["-"]
        for i, name in enumerate(loops):
            bd = {k.split("/", 1)[1]: v for k, v
                  in (perf.get("breakdown") or {}).items()
                  if k.split("/")[0] == name}
            bd_s = " ".join(f"{ph}={v * 1e3:.2f}ms" for ph, v
                            in sorted(bd.items())) or "-"
            first = i == 0
            lines.append(
                f"{str(p.get('role'))[:16] if first else '':<16} "
                f"{(str(p.get('host')) + ':' + str(p.get('pid'))) if first else '':<22} "
                f"{_f(mfu.get(name), '7.4f')} "
                f"{_f(perf.get('compiles_total') if first else None, '9.0f', '        -')} "
                f"{(_gb(hbm.get('in_use')) + '/' + _gb(hbm.get('limit'))) if first else '':>16} "
                f"{_gb(perf.get('kv_cache_bytes')) if first else '':>8}  "
                f"{name}: {bd_s}")
        kernel_ms.update(perf.get("kernel_ms") or {})
    if not any_perf:
        lines.append("(no perf data yet — engines/executors report "
                     "after their first compiled step)")
    if kernel_ms:
        lines.append("")
        lines.append("kernel margins (autobench, ms per candidate):")
        by_key: dict[str, dict[str, float]] = {}
        for kc, ms in kernel_ms.items():
            key, _, cand = kc.rpartition("/")
            by_key.setdefault(key, {})[cand] = ms
        for key in sorted(by_key):
            cands = by_key[key]
            finite = {c: m for c, m in cands.items()
                      if m is not None and m == m and m != float("inf")}
            win = min(finite, key=finite.get) if finite else "-"
            row = " ".join(
                f"{c}={'' if m is None else format(m, '.3f')}"
                + ("*" if c == win else "")
                for c, m in sorted(cands.items()))
            lines.append(f"  {key}: {row}")
    return "\n".join(lines)


def render_tier(fleet: dict) -> str:
    """The tiered-PS pane of a ``tel_fleet`` reply: per-shard warm/
    cold residency, hit split, fault/demotion totals, and the by-tier
    pull latency quantiles."""
    lines = [f"{'ROLE':<16} {'HOST:PID':<22} {'WARM rows/bytes':>18} "
             f"{'COLD rows/bytes':>18} {'HIT warm/cold':>15} "
             f"{'FAULTS':>8} {'DEMOTE':>8} {'ERR':>5} "
             f"{'PULL p50/p99':>15}"]
    any_tier = False
    for p in fleet.get("procs") or ():
        tier = (p.get("summary") or {}).get("tier") or {}
        if not tier:
            continue
        any_tier = True
        rows = tier.get("resident_rows") or {}
        nbytes = tier.get("resident_bytes") or {}
        hits = tier.get("hits") or {}
        lines.append(
            f"{str(p.get('role'))[:16]:<16} "
            f"{p.get('host')}:{p.get('pid'):<10} "
            f"{_f(rows.get('warm'), '8.0f')}/{_gb(nbytes.get('warm')):>9} "
            f"{_f(rows.get('cold'), '8.0f')}/{_gb(nbytes.get('cold')):>9} "
            f"{_f(hits.get('warm'), '7.0f')}/{_f(hits.get('cold'), '7.0f')} "
            f"{_f(tier.get('faults'), '8.0f')} "
            f"{_f(tier.get('demotions'), '8.0f')} "
            f"{_f(tier.get('cold_read_errors'), '5.0f', '    0')} "
            f"{_ms(tier.get('pull_p50'))}/{_ms(tier.get('pull_p99')):>7}")
    if not any_tier:
        lines.append("(no tiered tables yet — PS shards report after "
                     "PADDLE_PS_TIER_WARM_BYTES opts a table in)")
    return "\n".join(lines)


def render_prefix(fleet: dict) -> str:
    """The prefix-cache pane of a ``tel_fleet`` reply: per-engine hit
    ratio, prefill tokens the radix cache absorbed, COW/eviction churn,
    residency, and how much decode rides stochastic sampling
    (the serving engine's shared-prefix cache)."""
    lines = [f"{'ROLE':<16} {'HOST:PID':<22} {'HIT%':>6} {'LOOKUPS':>8} "
             f"{'TOK SAVED':>10} {'CACHED':>7} {'SHARED':>7} "
             f"{'COW':>5} {'EVICT':>6} {'SAMPLED req/tok':>16}"]
    any_prefix = False
    for p in fleet.get("procs") or ():
        pf = (p.get("summary") or {}).get("prefix") or {}
        if not pf:
            continue
        any_prefix = True
        ratio = pf.get("hit_ratio")
        lines.append(
            f"{str(p.get('role'))[:16]:<16} "
            f"{p.get('host')}:{p.get('pid'):<10} "
            f"{_f(None if ratio is None else ratio * 100, '6.1f')} "
            f"{_f(pf.get('lookups'), '8.0f')} "
            f"{_f(pf.get('tokens_saved'), '10.0f')} "
            f"{_f(pf.get('cached_pages'), '7.0f', '      0')} "
            f"{_f(pf.get('shared_pages'), '7.0f', '      0')} "
            f"{_f(pf.get('cow_copies'), '5.0f', '    0')} "
            f"{_f(pf.get('evicted'), '6.0f', '     0')} "
            f"{_f(pf.get('sampled_requests'), '7.0f', '      0')}/"
            f"{_f(pf.get('sampled_tokens'), '8.0f', '       0')}")
    if not any_prefix:
        lines.append("(no prefix-cache traffic yet — engines report "
                     "after PADDLE_TPU_PREFIX_CACHE_PAGES > 0 sees a "
                     "lookup)")
    return "\n".join(lines)


_SPARK = "▁▂▃▄▅▆▇█"


def sparkline(values, width: int = 48) -> str:
    """Unicode sparkline, min..max scaled, downsampled to `width` by
    last-value-per-cell (matching the TSDB's downsampling rule)."""
    vals = [float(v) for v in values if v is not None]
    if not vals:
        return ""
    if len(vals) > width:
        step = len(vals) / width
        vals = [vals[min(len(vals) - 1, int((i + 1) * step) - 1)]
                for i in range(width)]
    lo, hi = min(vals), max(vals)
    span = hi - lo
    if span <= 0:
        return _SPARK[0] * len(vals)
    return "".join(_SPARK[min(7, int((v - lo) / span * 8))]
                   for v in vals)


def render_history(reply: dict, metric: str, window: float = 300.0) \
        -> str:
    """Sparkline pane from a ``tsdb_query`` range reply: one line per
    matching series — label set, last value, min..max, sparkline."""
    pts = reply.get("points") or ()
    if reply.get("error"):
        return f"history {metric}: {reply['error']}"
    if not pts:
        return f"history {metric}: no samples in the last " \
               f"{window:.0f}s"
    lines = [f"history {metric}  last {window:.0f}s  "
             f"series={len(pts)}"]
    for s in pts:
        vals = [v for _, v in (s.get("points") or ())]
        if not vals:
            continue
        labels = s.get("labels") or {}
        tag = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
        lines.append(
            f"  {tag[:44]:<44} {sparkline(vals)} "
            f"last={vals[-1]:g} min={min(vals):g} max={max(vals):g}")
    return "\n".join(lines)


def render_alerts(reply: dict) -> str:
    """The alert pane from an ``alerts`` verb reply: firing/pending
    instances first, then recent transitions, then the rule table."""
    st = reply.get("alerts") or {}
    active = st.get("active") or ()
    lines = [f"alerts  active={len(active)}  "
             f"rules={len(st.get('rules') or ())}"]
    if active:
        lines.append(f"  {'STATE':<8} {'SEV':<6} {'RULE':<24} "
                     f"{'INSTANCE':<28} {'VALUE':>10}  SINCE")
        for a in active:
            since = a.get("since")
            stamp = time.strftime("%H:%M:%S", time.localtime(since)) \
                if since else "-"
            lines.append(
                f"  {a.get('state', '?'):<8} "
                f"{str(a.get('severity', '-')):<6} "
                f"{str(a.get('rule'))[:24]:<24} "
                f"{str(a.get('instance'))[:28]:<28} "
                f"{_f(a.get('value'), '10.3f')}  {stamp}"
                + (f"  bundle={a['bundle']}" if a.get("bundle")
                   else ""))
    else:
        lines.append("  (quiet — nothing pending or firing)")
    hist = st.get("history") or ()
    if hist:
        lines.append("recent transitions:")
        for h in list(hist)[-8:]:
            w = h.get("at")
            stamp = time.strftime("%H:%M:%S", time.localtime(w)) \
                if w else "--:--:--"
            lines.append(f"  {stamp} {h.get('rule')} "
                         f"[{h.get('instance')}] -> {h.get('state')}")
    return "\n".join(lines)


def render_tenants(reply: dict) -> str:
    """The per-tenant usage pane from a ``usage_report`` reply."""
    usage = reply.get("usage") or {}
    tenants = usage.get("tenants") or {}
    lines = [f"tenant usage ({usage.get('scope', '?')})"
             + (f"  window={usage['window_s']:.0f}s"
                if usage.get("window_s") else "")]
    if not tenants:
        lines.append("  (no tenant traffic metered yet)")
        return "\n".join(lines)
    lines.append(f"  {'TENANT':<16} {'TIER':<4} {'TOK IN':>10} "
                 f"{'TOK OUT':>10} {'QUEUE s':>9} {'KV PAGE s':>10} "
                 f"{'GFLOPs':>9}  OUTCOMES")
    for key in sorted(tenants):
        u = tenants[key]
        outs = u.get("outcomes") or {}
        outs_s = " ".join(f"{k}={v:g}" for k, v in sorted(outs.items())
                          if v) or "-"
        gflops = (u.get("flops") or 0.0) / 1e9
        lines.append(
            f"  {str(u.get('tenant'))[:16]:<16} "
            f"{str(u.get('tier')):<4} "
            f"{_f(u.get('tokens_in'), '10.0f')} "
            f"{_f(u.get('tokens_out'), '10.0f')} "
            f"{_f(u.get('queue_seconds'), '9.1f')} "
            f"{_f(u.get('kv_page_seconds'), '10.1f')} "
            f"{gflops:9.3f}  {outs_s}")
    return "\n".join(lines)


def render_waterfall(trace: dict) -> str:
    """The assembled cross-process waterfall of one ``tel_trace``
    reply: spans in aligned start order, indented by span parentage,
    one rank tag per line."""
    spans = trace.get("spans") or ()
    if not spans:
        return f"trace {trace.get('trace_id')}: no spans"
    t0 = min(s["t0"] for s in spans)
    t1 = max(s["t1"] for s in spans)
    by_id = {s.get("span_id"): s for s in spans}

    def depth(s, limit=16):
        d = 0
        while d < limit:
            pid_ = s.get("parent_id")
            if not pid_ or pid_ not in by_id:
                return d
            s = by_id[pid_]
            d += 1
        return d

    head = [f"trace {trace.get('trace_id')}  "
            f"{(t1 - t0) * 1000:.2f}ms  "
            f"spans={len(spans)} procs={len(trace.get('procs') or ())}"
            f"  verdict={trace.get('verdict', 'open')}"
            f"{'' if trace.get('complete', True) else '  (incomplete)'}"]
    if trace.get("error"):
        head.append("  ** contains errors/deadline misses **")
    if trace.get("watchdog_flagged"):
        head.append("  ** watchdog flagged **")
    lines = head
    width = 30
    span_ms = max(1e-9, t1 - t0)
    for s in sorted(spans, key=lambda x: (x["t0"], x["t1"])):
        off = (s["t0"] - t0)
        dur = max(0.0, s["t1"] - s["t0"])
        a = int(width * off / span_ms)
        b = max(1, int(width * dur / span_ms))
        bar = " " * a + "#" * min(b, width - a)
        lines.append(
            f"{off * 1000:9.2f}ms {bar:<{width}} "
            f"{'  ' * depth(s)}{s['name']} ({dur * 1000:.2f}ms) "
            f"[{s.get('role')}@{s.get('host')}:{s.get('pid')}]")
    flights = trace.get("flight") or ()
    if flights:
        lines.append(f"flight events: "
                     + ", ".join(sorted({f"{e.get('tier')}/{e.get('kind')}"
                                         for e in flights})))
    return "\n".join(lines)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch.observability.top",
        description="live fleet dashboard / trace waterfall viewer")
    ap.add_argument("cmd", nargs="?", default="top",
                    choices=["top", "trace", "perf", "tier", "prefix",
                             "history", "alerts", "tenants"])
    ap.add_argument("trace_id", nargs="?",
                    help="trace: trace id; history: metric name")
    ap.add_argument("--collector", default=os.environ.get(
        "PADDLE_TPU_TELEMETRY_COLLECTOR") or "127.0.0.1:8600")
    ap.add_argument("--interval", type=float, default=1.0)
    ap.add_argument("--once", action="store_true",
                    help="print one snapshot and exit (no ANSI)")
    ap.add_argument("--out", help="trace: write the merged Chrome "
                                  "trace JSON here")
    ap.add_argument("--window", type=float, default=300.0,
                    help="history/tenants: trailing seconds")
    args = ap.parse_args(argv)

    from ..distributed.fleet.runtime.rpc import RpcClient
    cli = RpcClient(args.collector,
                    secret=os.environ.get("PADDLE_PS_SECRET") or None,
                    timeout=5.0, deadline=5.0, max_retries=0)
    try:
        if args.cmd == "trace":
            if not args.trace_id:
                print("usage: ... trace <trace_id>", file=sys.stderr)
                return 2
            rep = cli.call({"op": "tel_trace",
                            "trace_id": args.trace_id,
                            "chrome": bool(args.out)})
            tr = rep.get("trace")
            if tr is None:
                print(f"trace {args.trace_id}: not retained "
                      f"(unknown or sampled out)", file=sys.stderr)
                return 1
            print(render_waterfall(tr))
            if args.out and rep.get("chrome") is not None:
                with open(args.out, "w", encoding="utf-8") as f:
                    json.dump(rep["chrome"], f)
                print(f"chrome trace -> {args.out}")
            return 0
        if args.cmd == "history" and not args.trace_id:
            print("usage: ... history <metric>", file=sys.stderr)
            return 2
        # live loop (or one shot); each pane knows its own verb
        while True:
            if args.cmd == "history":
                rep = cli.call({"op": "tsdb_query", "query": "range",
                                "metric": args.trace_id,
                                "window": args.window})
                text = render_history(rep, args.trace_id, args.window)
            elif args.cmd == "alerts":
                text = render_alerts(cli.call({"op": "alerts"}))
            elif args.cmd == "tenants":
                text = render_tenants(cli.call(
                    {"op": "usage_report", "window": args.window}))
            else:
                render = {"perf": render_perf,
                          "tier": render_tier,
                          "prefix": render_prefix}.get(args.cmd,
                                                       render_fleet)
                fleet = cli.call({"op": "tel_fleet"})["fleet"]
                text = render(fleet)
            if args.once:
                print(text)
                return 0
            sys.stdout.write("\x1b[2J\x1b[H" + text + "\n")
            sys.stdout.flush()
            time.sleep(max(0.2, args.interval))
    except KeyboardInterrupt:
        return 0
    finally:
        cli.close()


if __name__ == "__main__":
    raise SystemExit(main())

"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # every phase (needs one CUDA card)
    python3 chip_smoke.py --kernels  # phases 1-2 only: build + check
    python3 chip_smoke.py --profile  # also: device-time breakdown of
                                     # 10 decode steps (torch.profiler)

Phases:
  1. card and build — the card's name and power limit, then nvcc builds
     every kernel of the serving path from ``paddle_tpu_torch/ops/csrc``;
  2. each kernel against its plain PyTorch version on the card, at the
     shapes the GPT-3 XL serving path gives it, with its time (CUDA
     events, median, L2 flushed between launches), the plain version's
     time, one PyTorch library call chain's time as a yardstick, and the
     least time the card could take (bytes over HBM rate or flops over
     the f32 rate, whichever is larger);
  3. the main path — ``Engine(GPTDecodeModel(GPTConfig.gpt3_1p3b()))``
     serves a request mix (greedy, seeded-sampled, and a shared-prefix
     pair that takes prefill_tail); every request must end "done", every
     kernel must have launched, and one greedy request must decode the
     same tokens when served by the plain versions on the card;
  4. the kernels line, then the card line, then the result line.

Any failed phase exits non-zero before the result line.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# Data-sheet rates of the H100 SXM (NVIDIA): f32 outside the tensor
# cores, HBM3. The port's serving path computes in f32 with TF32 off.
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

PAGED_SRC = "paddle_tpu_torch/ops/csrc/paged_attention.cu"
BLOCK_SRC = "paddle_tpu_torch/ops/csrc/fused_block.cu"
REPLACES = {
    "paged_attention": "paddle_tpu/ops/paged_attention.py:76 _paged_kernel "
                       "(paged_attention_pallas :114)",
    "fused_out_ln": "paddle_tpu/ops/pallas_block.py:152 _out_ln_kernel "
                    "(_out_ln_pallas :179)",
    "fused_ffn_ln": "paddle_tpu/ops/pallas_block.py:321 _ffn_ln_kernel "
                    "(_ffn_ln_pallas :358)",
}


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


class Timer:
    """Median CUDA-event time of fn() in ms; a 128 MB write between
    launches evicts the 50 MB L2, as the layers in between would."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(32 << 20, dtype=torch.float32,
                                 device="cuda")

    def __call__(self, fn, reps: int = 15, warm: int = 2) -> float:
        torch = self.torch
        for _ in range(warm):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)


def check_paged(torch, timer, results):
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.paged_attention import (
        paged_attention_decode, paged_attention_reference)
    S, H, d, ps = 8, 16, 128, 16
    M = 2048 // ps
    P = S * M
    g = torch.Generator(device="cuda").manual_seed(0)
    ctx = torch.tensor([1, 17, 100, 300, 700, 1200, 1777, 2048],
                       dtype=torch.int32, device="cuda")
    perm = torch.randperm(P, generator=g, device="cuda")
    pt = perm.reshape(S, M).to(torch.int32).contiguous()
    # the trash page (index P) is a valid page: point one slot's unused
    # tail at it, as the engine does
    pt[0, 1:] = P
    q = torch.randn(S, H, d, generator=g, device="cuda")
    scale = d ** -0.5
    n_tok = int(ctx.sum())
    for name, dt, tol in (("f32", torch.float32, 2e-5),
                          ("bf16", torch.bfloat16, 2e-2)):
        k = torch.randn(P + 1, ps, H, d, generator=g, device="cuda").to(dt)
        v = torch.randn(P + 1, ps, H, d, generator=g, device="cuda").to(dt)
        args = (q, k, v, pt, ctx, scale)
        got = paged_attention_decode(*args)
        ref = paged_attention_reference(*args)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        # library yardstick: SDPA over the gathered, masked context (the
        # gather itself is outside the timed call)
        kd = k[pt.long()].reshape(S, M * ps, H, d).permute(0, 2, 1, 3)
        vd = v[pt.long()].reshape(S, M * ps, H, d).permute(0, 2, 1, 3)
        kd, vd = kd.float().contiguous(), vd.float().contiguous()
        mask = (torch.arange(M * ps, device="cuda")[None, :]
                < ctx[:, None])[:, None, None, :]
        qd = q[:, :, None, :]
        item = k.element_size()
        nbytes = q.numel() * 4 * 2 + 2 * n_tok * H * d * item \
            + pt.numel() * 4 + S * 4
        flops = 4 * n_tok * H * d
        bms, by = bound(nbytes, flops)
        row = {"kernel": "paged_attention", "shape": f"S={S} H={H} d={d} "
               f"ps={ps} ctx<=2048 cache={name}", "max_abs_err": err,
               "tol": tol, "kernel_ms": timer(lambda: paged_attention_decode(
                   *args)),
               "plain_ms": timer(lambda: paged_attention_reference(*args)),
               "library_ms": timer(lambda: F.scaled_dot_product_attention(
                   qd, kd, vd, attn_mask=mask, scale=scale)),
               "bound_ms": bms, "bound_by": by}
        print(json.dumps(row), flush=True)
        results.append(row)
        if not err <= tol:
            fail(f"paged_attention ({name}) max abs err {err} > {tol}")
        del k, v, kd, vd


def check_blocks(torch, timer, results):
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.fused_block import (
        ffn_ln_reference, fused_ffn_ln, fused_out_ln, out_ln_reference)
    D, I = 2048, 8192
    g = torch.Generator(device="cuda").manual_seed(1)

    def rn(*shape, s=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * s

    w = rn(D, D, s=0.02)
    b = rn(D, s=0.02)
    ln_s = 1.0 + rn(D, s=0.1)
    ln_b = rn(D, s=0.1)
    w1 = rn(D, I, s=0.02)
    b1 = rn(I, s=0.02)
    w2 = rn(I, D, s=0.01)
    b2 = rn(D, s=0.02)
    tol = 1e-4
    for M in (8, 256):
        a = rn(M, D)
        res = rn(M, D)
        z, h = fused_out_ln(a, w, b, res, ln_s, ln_b)
        zr, hr = out_ln_reference(a, w, b, res, ln_s, ln_b)
        torch.cuda.synchronize()
        err = max(float((z - zr).abs().max()), float((h - hr).abs().max()))
        nbytes = 4 * (M * D + D * D + D + M * D + 2 * D + 2 * M * D)
        bms, by = bound(nbytes, 2 * M * D * D + 10 * M * D)

        def lib_out():
            zz = torch.addmm(b, a, w).add_(res)
            return F.layer_norm(zz, (D,), ln_s, ln_b, 1e-5)

        row = {"kernel": "fused_out_ln", "shape": f"M={M} D={D} f32",
               "max_abs_err": err, "tol": tol,
               "kernel_ms": timer(lambda: fused_out_ln(a, w, b, res, ln_s,
                                                       ln_b)),
               "plain_ms": timer(lambda: out_ln_reference(a, w, b, res, ln_s,
                                                          ln_b)),
               "library_ms": timer(lib_out), "bound_ms": bms,
               "bound_by": by}
        print(json.dumps(row), flush=True)
        results.append(row)
        if not err <= tol:
            fail(f"fused_out_ln M={M} max abs err {err} > {tol}")

        x = rn(M, D)
        out = fused_ffn_ln(x, w1, b1, w2, b2, res)
        ref = ffn_ln_reference(x, w1, b1, w2, b2, res)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        nbytes = 4 * (M * D + D * I + I + I * D + D + M * D + M * D)
        bms, by = bound(nbytes, 4 * M * D * I + 10 * M * I)

        def lib_ffn():
            u = F.gelu(torch.addmm(b1, x, w1), approximate="tanh")
            return torch.addmm(b2, u, w2).add_(res)

        row = {"kernel": "fused_ffn_ln", "shape": f"M={M} H={D} I={I} f32",
               "max_abs_err": err, "tol": tol,
               "kernel_ms": timer(lambda: fused_ffn_ln(x, w1, b1, w2, b2,
                                                       res)),
               "plain_ms": timer(lambda: ffn_ln_reference(x, w1, b1, w2, b2,
                                                          res)),
               "library_ms": timer(lib_ffn), "bound_ms": bms,
               "bound_by": by}
        print(json.dumps(row), flush=True)
        results.append(row)
        if not err <= tol:
            fail(f"fused_ffn_ln M={M} max abs err {err} > {tol}")


def request_mix(vocab: int):
    """8 requests, prompt lengths from the serving benchmark's mix
    {16, 31, 64, 100, 128, 192}, 16-32 new tokens; request 0 and
    request 7 share a 64-token (4-page) prefix; request 5 samples."""
    import numpy as np
    rng = np.random.RandomState(0)
    plens = [128, 16, 31, 64, 100, 192, 31, 100]
    news = [24, 16, 32, 20, 28, 32, 16, 24]
    mix = []
    for i, (pl, mn) in enumerate(zip(plens, news)):
        prompt = rng.randint(0, vocab, (pl,))
        kw = dict(temperature=0.8, top_k=40, top_p=0.95, seed=1234) \
            if i == 5 else {}
        mix.append([prompt, mn, kw])
    mix[7][0][:64] = mix[0][0][:64]
    return mix


def main_path(torch):
    from paddle_tpu_torch.models.gpt import GPTConfig
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    from paddle_tpu_torch.serving import Engine, GPTDecodeModel
    cfg = GPTConfig.gpt3_1p3b()
    t0 = time.perf_counter()
    model = GPTDecodeModel(cfg, seed=0)
    torch.cuda.synchronize()
    print(json.dumps({"phase": "model", "config": "gpt3_1p3b",
                      "init_s": round(time.perf_counter() - t0, 2)}),
          flush=True)
    eng = Engine(model, num_slots=8, num_pages=256, page_size=16,
                 prefix_cache_pages=64)
    mix = request_mix(cfg.vocab_size)

    reset_launch_counts()
    t0 = time.perf_counter()
    first = eng.submit(mix[0][0], mix[0][1], **mix[0][2])
    eng.step()             # prefill request 0 so its pages are cached
    reqs = [first] + [eng.submit(p, n, **kw) for p, n, kw in mix[1:]]
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()

    bad = [(r.id, r.status, r.error) for r in reqs if r.status != "done"]
    if bad:
        fail(f"requests not done: {bad}")
    for r, (_p, n, _kw) in zip(reqs, mix):
        toks = r.result()
        if len(toks) != n or toks.min() < 0 or toks.max() >= cfg.vocab_size:
            fail(f"request {r.id}: {len(toks)} tokens, range "
                 f"[{toks.min()}, {toks.max()}]")
    missing = [k for k in REPLACES if counts.get(k, 0) <= 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing} "
             f"(counts {counts})")
    st = eng.stats()
    if st["prefix_cache"]["hits"] < 1 \
            or not any(k.startswith("prefill_tail") for k in st["compiles"]):
        fail(f"shared-prefix request did not take prefill_tail: "
             f"{st['prefix_cache']} {st['compiles']}")
    ntok = sum(len(r.generated) for r in reqs)
    h = eng._m_decode_h
    main = {"phase": "main_path", "requests": len(reqs), "tokens": ntok,
            "wall_s": round(wall, 3), "tokens_per_s": round(ntok / wall, 2),
            "latency_ms_p50": st["latency_ms_p50"],
            "latency_ms_p99": st["latency_ms_p99"],
            "decode_steps": st["steps"],
            "decode_step_ms_mean": round(h.sum / h.count * 1e3, 3),
            "compiles": st["compiles"], "launches": counts}
    print(json.dumps(main), flush=True)

    # one greedy request again, served by the plain versions on the card
    plain_model = GPTDecodeModel(dataclasses.replace(cfg,
                                                     fused_blocks=False),
                                 params=model.params, attn_impl="plain")
    plain = Engine(plain_model, num_slots=8, num_pages=64, page_size=16)
    p, n, _ = mix[3]
    pr = plain.submit(p, n)
    plain.run_until_idle()
    got, want = reqs[3].result().tolist(), pr.result().tolist()
    print(json.dumps({"phase": "plain_parity", "request": 3,
                      "kernel_tokens": got, "plain_tokens": want}),
          flush=True)
    if got != want:
        fail("greedy tokens differ between the kernels and the plain "
             "versions")
    return counts, main, eng


def profile_decode(torch, eng, vocab, steps=10):
    """Device time by kernel over `steps` full-batch decode steps (8
    slots, 64-token prompts): each kernel's total ms and launches, and
    the device's busy share of the wall time."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.RandomState(1)
    reqs = [eng.submit(rng.randint(0, vocab, (64,)), steps + 8)
            for _ in range(eng.num_slots)]
    for _ in range(3):                 # admit + prefill all, warm decode
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    eng.run_until_idle()
    if any(r.status != "done" for r in reqs):
        fail("profiled requests did not finish")
    from paddle_tpu_torch.observability import TRACER
    spans = {sp.name for sp in TRACER.spans()}
    by_name: dict[str, list] = {}
    for e in prof.events():
        # device work only: kernels, copies and sets, not the host spans
        # that record_function mirrors onto the device timeline
        if e.device_type != DeviceType.CUDA or e.name in spans \
                or getattr(e, "is_user_annotation", False):
            continue
        name = e.name.replace("(anonymous namespace)::", "")
        name = name.removeprefix("void ").split("(")[0]
        ent = by_name.setdefault(name[:60], [0.0, 0])
        ent[0] += e.time_range.elapsed_us() / 1e3
        ent[1] += 1
    busy = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    print(json.dumps({
        "phase": "profile", "decode_steps": steps,
        "wall_ms_per_step": round(wall * 1e3 / steps, 3),
        "device_busy_ms_per_step": round(busy / steps, 3),
        "device_busy_share": round(busy / (wall * 1e3), 4),
        "top_kernels": [{"name": k, "ms_per_step": round(v[0] / steps, 4),
                         "launches_per_step": v[1] / steps}
                        for k, v in top]}), flush=True)


def main(argv):
    kernels_only = "--kernels" in argv
    with_profile = "--profile" in argv
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA card (torch.cuda.is_available() is False)")
    try:
        from paddle_tpu_torch.ops import _build
    except ImportError as e:
        fail(f"paddle_tpu_torch is not importable next to this script: {e}")
    card = card_line()
    print(card, flush=True)
    print(json.dumps({"phase": "versions", "python": sys.version.split()[0],
                      "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    t0 = time.perf_counter()
    secs = _build.build_all()
    print(json.dumps({"phase": "build", "seconds": round(
        time.perf_counter() - t0, 2), "per_source": secs}), flush=True)
    for name, log in _build.build_log().items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", file=sys.stderr)

    timer = Timer(torch)
    results = []
    check_paged(torch, timer, results)
    check_blocks(torch, timer, results)
    del timer
    torch.cuda.empty_cache()
    if kernels_only:
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return

    counts, _main, eng = main_path(torch)
    if with_profile:
        profile_decode(torch, eng, eng.model.cfg.vocab_size)
    del eng

    # the main path's shapes: decode (M = 8 slots, f32 cache)
    pick = {"paged_attention": "cache=f32", "fused_out_ln": "M=8 ",
            "fused_ffn_ln": "M=8 "}
    kernels = []
    for name, key in pick.items():
        row = next(r for r in results
                   if r["kernel"] == name and key in r["shape"])
        kernels.append({
            "name": name, "route": "cuda",
            "source": PAGED_SRC if name == "paged_attention" else BLOCK_SRC,
            "replaces": REPLACES[name], "launches": counts.get(name, 0),
            "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])

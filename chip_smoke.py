"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # every phase (needs one CUDA card)
    python3 chip_smoke.py --kernels  # phases 1-2 only: build + check
    python3 chip_smoke.py --profile  # also: device-time breakdowns of
                                     # 10 decode steps and of one train
                                     # step (torch.profiler)

Phases:
  1. card and build — the card's name and power limit, then nvcc builds
     every kernel of the port from ``paddle_tpu_torch/ops/csrc``, one
     process per source, all at once;
  2. each kernel against its plain PyTorch version on the card, at the
     shapes the GPT-3 XL serving and training paths give it, with its
     time (CUDA events, median, L2 flushed between launches), the plain
     version's time, one PyTorch library call chain's time as a
     yardstick, and the least time the card could take (bytes over HBM
     rate or flops over the peak rate of the input type, whichever is
     larger): paged attention and the two sub-blocks at decode (f32),
     the sub-blocks at the training shape (bf16, M = 1024 tokens), and
     the three flash kernels at B=1, H=16, T=1024, D=128, causal, in
     bf16 and f32;
  3. the serving path — ``Engine(GPTDecodeModel(GPTConfig.gpt3_1p3b()))``
     serves a request mix (greedy, seeded-sampled, and a shared-prefix
     pair that takes prefill_tail); every request must end "done", every
     kernel of the path must have launched, and one greedy request must
     decode the same tokens when served by the plain versions on the
     card;
  4. train parity — ``HybridParallelTrainStep`` on GPT-3 XL cut to 2
     layers at full width, bf16, 3 steps of 1 x 1024 tokens, through the
     kernels (flash, fused sub-blocks) and through the composed chain,
     same weights and ids: every step's loss must agree within 2e-2
     relative;
  5. the training path — the repo's GPT-3 XL train step (bench.py's
     bench_gpt_1p3b: bf16, flash, remat, dp=pp=tp=1, clip 1.0, batch 1 x
     1024), 1 warm-up + 4 timed steps: finite losses, the last below the
     first, every training kernel launched; step ms, tokens/s, MFU and
     peak device memory;
  6. the kernels line, then the card line, then the result line.

One numpy weight tree (seed 0, 1.3 B parameters) feeds phases 3-5.
Any failed phase exits non-zero before the result line.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# Data-sheet rates of the H100 SXM (NVIDIA): f32 outside the tensor
# cores, bf16 dense tensor cores, HBM3. The port computes f32 with TF32
# off; a kernel's bound uses the peak of its input type.
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

PAGED_SRC = "paddle_tpu_torch/ops/csrc/paged_attention.cu"
BLOCK_SRC = "paddle_tpu_torch/ops/csrc/fused_block.cu"
FLASH_SRC = "paddle_tpu_torch/ops/csrc/flash_attention.cu"
SOURCE = {"paged_attention": PAGED_SRC, "fused_out_ln": BLOCK_SRC,
          "fused_ffn_ln": BLOCK_SRC, "flash_fwd": FLASH_SRC,
          "flash_bwd_dq": FLASH_SRC, "flash_bwd_dkv": FLASH_SRC}
REPLACES = {
    "paged_attention": "paddle_tpu/ops/paged_attention.py:76 _paged_kernel "
                       "(paged_attention_pallas :114)",
    "fused_out_ln": "paddle_tpu/ops/pallas_block.py:152 _out_ln_kernel "
                    "(_out_ln_pallas :179)",
    "fused_ffn_ln": "paddle_tpu/ops/pallas_block.py:321 _ffn_ln_kernel "
                    "(_ffn_ln_pallas :358)",
    "flash_fwd": "paddle_tpu/ops/pallas_attention.py:127 _fwd_kernel "
                 "(_flash_fwd_impl :288, pallas_call :316)",
    "flash_bwd_dq": "paddle_tpu/ops/pallas_attention.py:185 _bwd_dq_kernel "
                    "(_flash_bwd :337, pallas_call :375)",
    "flash_bwd_dkv": "paddle_tpu/ops/pallas_attention.py:222 "
                     "_bwd_dkv_kernel (_flash_bwd :337, pallas_call :410)",
}
SERVING_KERNELS = ("paged_attention", "fused_out_ln", "fused_ffn_ln")
TRAINING_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                    "fused_out_ln", "fused_ffn_ln")
TRAIN_TOKENS = 1024


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, flops: float,
          peak: float = F32_FLOPS) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def max_err(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max())


def within(got, ref, atol: float, rtol: float) -> bool:
    """torch.allclose's criterion, |got - ref| <= atol + rtol |ref|,
    everywhere (NaN fails)."""
    g, r = got.float(), ref.float()
    return bool(((g - r).abs() <= atol + rtol * r.abs()).all())


def report(results, row, ok: bool):
    print(json.dumps(row), flush=True)
    results.append(row)
    if not ok:
        fail(f"{row['kernel']} ({row['shape']}) max abs err "
             f"{row['max_abs_err']} outside tolerance {row['tol']}")


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
        report(results, row, err <= tol)
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
        report(results, row, err <= tol)

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
        report(results, row, err <= tol)


def check_blocks_bf16(torch, timer, results):
    """The sub-blocks at the training shape: bf16 activations, weights
    and biases with f32 LN vectors, M = 1024 tokens. Tolerance: both the
    kernel and the plain version accumulate in f32 from the same bf16
    numbers and round each output once to bf16 (2**-8 relative), so
    |err| <= 2e-2 + 2e-2 |ref|."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.fused_block import (
        ffn_ln_reference, fused_ffn_ln, fused_out_ln, out_ln_reference)
    M, D, I = TRAIN_TOKENS, 2048, 8192
    bf = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(2)

    def rn(*shape, s=1.0, dt=bf):
        return (torch.randn(*shape, generator=g, device="cuda") * s).to(dt)

    w, b = rn(D, D, s=0.02), rn(D, s=0.02)
    ln_s, ln_b = rn(D, s=0.1, dt=torch.float32) + 1.0, \
        rn(D, s=0.1, dt=torch.float32)
    w1, b1 = rn(D, I, s=0.02), rn(I, s=0.02)
    w2, b2 = rn(I, D, s=0.01), rn(D, s=0.02)
    a, res, x = rn(M, D), rn(M, D), rn(M, D)
    tol = {"atol": 2e-2, "rtol": 2e-2}

    z, h = fused_out_ln(a, w, b, res, ln_s, ln_b)
    zr, hr = out_ln_reference(a, w, b, res, ln_s, ln_b)
    torch.cuda.synchronize()
    nbytes = 2 * (M * D + D * D + D + M * D + 2 * M * D) + 4 * 2 * D
    bms, by = bound(nbytes, 2 * M * D * D + 10 * M * D, BF16_FLOPS)
    ls16, lb16 = ln_s.to(bf), ln_b.to(bf)

    def lib_out():
        zz = torch.addmm(b, a, w).add_(res)
        return F.layer_norm(zz, (D,), ls16, lb16, 1e-5)

    row = {"kernel": "fused_out_ln", "shape": f"M={M} D={D} bf16",
           "max_abs_err": max(max_err(z, zr), max_err(h, hr)), "tol": tol,
           "kernel_ms": timer(lambda: fused_out_ln(a, w, b, res, ln_s,
                                                   ln_b)),
           "plain_ms": timer(lambda: out_ln_reference(a, w, b, res, ln_s,
                                                      ln_b)),
           "library_ms": timer(lib_out), "bound_ms": bms, "bound_by": by}
    report(results, row, within(z, zr, **tol) and within(h, hr, **tol))

    out = fused_ffn_ln(x, w1, b1, w2, b2, res)
    ref = ffn_ln_reference(x, w1, b1, w2, b2, res)
    torch.cuda.synchronize()
    nbytes = 2 * (M * D + D * I + I + I * D + D + M * D + M * D)
    bms, by = bound(nbytes, 4 * M * D * I + 10 * M * I, BF16_FLOPS)

    def lib_ffn():
        u = F.gelu(torch.addmm(b1, x, w1), approximate="tanh")
        return torch.addmm(b2, u, w2).add_(res)

    row = {"kernel": "fused_ffn_ln", "shape": f"M={M} H={D} I={I} bf16 "
           f"(f32 partials {I // 128 * M * D * 4 / 1e6:.0f} MB)",
           "max_abs_err": max_err(out, ref), "tol": tol,
           "kernel_ms": timer(lambda: fused_ffn_ln(x, w1, b1, w2, b2, res)),
           "plain_ms": timer(lambda: ffn_ln_reference(x, w1, b1, w2, b2,
                                                      res)),
           "library_ms": timer(lib_ffn), "bound_ms": bms, "bound_by": by}
    report(results, row, within(out, ref, **tol))


def check_flash(torch, timer, results):
    """The three flash kernels at the training shape (B=1, H=16, T=1024,
    D=128, causal) in bf16 (the training path's type) and f32.
    Tolerances: f32, |err| <= 1e-4 + 1e-4 |ref| (sums of up to 1024
    terms in another order); bf16, 2e-2 + 2e-2 |ref| (f32 arithmetic on
    the same bf16 numbers on both sides, one rounding of each output to
    bf16); lse is f32 in both, 1e-4."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import flash_attention as fa
    B, H, T, D = 1, 16, TRAIN_TOKENS, 128
    BH = B * H
    scale = D ** -0.5
    g = torch.Generator(device="cuda").manual_seed(3)
    # score elements the causal kernels need: T (T + 1) / 2 per head
    n_el = BH * T * (T + 1) // 2
    for name, dt, peak, t in (("bf16", torch.bfloat16, BF16_FLOPS, 2e-2),
                              ("f32", torch.float32, F32_FLOPS, 1e-4)):
        tol = {"atol": t, "rtol": t}
        q, k, v, do = (torch.randn(BH, T, D, generator=g, device="cuda")
                       .to(dt) for _ in range(4))
        item = q.element_size()
        shape = f"B={B} H={H} T={T} D={D} causal {name}"
        q4, k4, v4, do4 = (a.reshape(B, H, T, D) for a in (q, k, v, do))

        o, lse = fa._fwd_kernel(q, k, v, scale, True)
        o_r, lse_r = fa.flash_fwd_reference(q, k, v, scale, True)
        torch.cuda.synchronize()
        bms, by = bound(item * 4 * BH * T * D + 4 * BH * T, 4 * D * n_el,
                        peak)
        row = {"kernel": "flash_fwd", "shape": shape,
               "max_abs_err": max(max_err(o, o_r), max_err(lse, lse_r)),
               "tol": tol,
               "kernel_ms": timer(lambda: fa._fwd_kernel(q, k, v, scale,
                                                         True)),
               "plain_ms": timer(lambda: fa.flash_fwd_reference(
                   q, k, v, scale, True)),
               "library_ms": timer(lambda: F.scaled_dot_product_attention(
                   q4, k4, v4, is_causal=True)),
               "bound_ms": bms, "bound_by": by}
        report(results, row, within(o, o_r, **tol)
               and within(lse, lse_r, 1e-4, 1e-4))

        # library yardstick of the backward kernels: SDPA forward +
        # backward (the same call for both rows)
        ql, kl, vl = (a.detach().clone().requires_grad_()
                      for a in (q4, k4, v4))

        def lib_bwd():
            out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
            return torch.autograd.grad(out, (ql, kl, vl), do4)

        lib_ms = timer(lib_bwd)
        delta = fa.bwd_delta(o, do)
        args = (q, k, v, do, lse, delta, scale, True)
        plain_args = (q, k, v, o, lse, do, scale, True)
        dq = fa._dq_kernel(*args)
        dq_r = fa.bwd_dq_reference(*plain_args)
        torch.cuda.synchronize()
        bms, by = bound(item * 5 * BH * T * D + 8 * BH * T, 6 * D * n_el,
                        peak)
        row = {"kernel": "flash_bwd_dq", "shape": shape,
               "max_abs_err": max_err(dq, dq_r), "tol": tol,
               "kernel_ms": timer(lambda: fa._dq_kernel(*args)),
               "plain_ms": timer(lambda: fa.bwd_dq_reference(*plain_args)),
               "library_ms": lib_ms, "bound_ms": bms, "bound_by": by}
        report(results, row, within(dq, dq_r, **tol))

        dk, dv = fa._dkv_kernel(*args)
        dk_r, dv_r = fa.bwd_dkv_reference(*plain_args)
        torch.cuda.synchronize()
        bms, by = bound(item * 6 * BH * T * D + 8 * BH * T, 8 * D * n_el,
                        peak)
        row = {"kernel": "flash_bwd_dkv", "shape": shape,
               "max_abs_err": max(max_err(dk, dk_r), max_err(dv, dv_r)),
               "tol": tol,
               "kernel_ms": timer(lambda: fa._dkv_kernel(*args)),
               "plain_ms": timer(lambda: fa.bwd_dkv_reference(*plain_args)),
               "library_ms": lib_ms, "bound_ms": bms, "bound_by": by}
        report(results, row, within(dk, dk_r, **tol)
               and within(dv, dv_r, **tol))


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


def serving_path(torch, tree):
    from paddle_tpu_torch.models.gpt import GPTConfig
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    from paddle_tpu_torch.serving import Engine, GPTDecodeModel
    cfg = GPTConfig.gpt3_1p3b()
    t0 = time.perf_counter()
    model = GPTDecodeModel(cfg, params=tree)
    torch.cuda.synchronize()
    print(json.dumps({"phase": "model", "config": "gpt3_1p3b",
                      "upload_s": round(time.perf_counter() - t0, 2)}),
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
    missing = [k for k in SERVING_KERNELS if counts.get(k, 0) <= 0]
    if missing:
        fail(f"kernels never launched on the serving path: {missing} "
             f"(counts {counts})")
    st = eng.stats()
    if st["prefix_cache"]["hits"] < 1 \
            or not any(k.startswith("prefill_tail") for k in st["compiles"]):
        fail(f"shared-prefix request did not take prefill_tail: "
             f"{st['prefix_cache']} {st['compiles']}")
    ntok = sum(len(r.generated) for r in reqs)
    h = eng._m_decode_h
    main = {"phase": "serving_path", "requests": len(reqs), "tokens": ntok,
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
    return counts, eng


def profile_steps(torch, run, steps, what, top_n=12):
    """Device time by kernel over `steps` calls of run(): each kernel's
    ms and launches per step, and the device's busy share of the wall
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.observability import TRACER
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top_n]
    print(json.dumps({
        "phase": "profile", "what": what, "steps": steps,
        "wall_ms_per_step": round(wall * 1e3 / steps, 3),
        "device_busy_ms_per_step": round(busy / steps, 3),
        "device_busy_share": round(busy / (wall * 1e3), 4),
        "top_kernels": [{"name": k, "ms_per_step": round(v[0] / steps, 4),
                         "launches_per_step": v[1] / steps}
                        for k, v in top]}), flush=True)


def profile_decode(torch, eng, vocab, steps=10):
    """Device-time breakdown of `steps` full-batch decode steps (8
    slots, 64-token prompts)."""
    import numpy as np
    rng = np.random.RandomState(1)
    reqs = [eng.submit(rng.randint(0, vocab, (64,)), steps + 8)
            for _ in range(eng.num_slots)]
    for _ in range(3):                 # admit + prefill all, warm decode
        eng.step()
    profile_steps(torch, eng.step, steps, "decode")
    eng.run_until_idle()
    if any(r.status != "done" for r in reqs):
        fail("profiled requests did not finish")


def train_ids(vocab: int):
    import numpy as np
    return np.random.RandomState(0).randint(
        0, vocab, (1, TRAIN_TOKENS)).astype(np.int32)


def train_parity(torch, tree, layers=2, steps=3, rtol=2e-2):
    """The kernel train step against the composed one on GPT-3 XL cut to
    `layers` layers (full width, bf16), same weights and ids. Both run
    bf16 blocks that round at different places (the kernels keep P, the
    gelu intermediate and the LN input in f32), so the curves agree to
    bf16 precision: within `rtol` relative."""
    import math
    from paddle_tpu_torch.models.gpt import GPTConfig
    from paddle_tpu_torch.parallel import HybridParallelTrainStep
    small = {k: tree[k] for k in ("wte", "wpe", "lnf_s", "lnf_b")}
    small["blocks"] = {k: v[:layers] for k, v in tree["blocks"].items()}
    curves = {}
    for name, kw in (("kernels", dict(attn_impl="flash", fused_blocks=True)),
                     ("composed", dict(attn_impl="xla",
                                       fused_blocks=False))):
        cfg = GPTConfig.gpt3_1p3b(num_layers=layers, amp_dtype="bfloat16",
                                  remat=True, **kw)
        step = HybridParallelTrainStep(cfg, grad_clip_norm=1.0,
                                       params=small)
        ids = train_ids(cfg.vocab_size)
        curves[name] = [float(step(ids)) for _ in range(steps)]
        del step
        torch.cuda.empty_cache()
    rel = [abs(a - b) / abs(b) for a, b in zip(curves["kernels"],
                                                curves["composed"])]
    print(json.dumps({"phase": "train_parity", "layers": layers,
                      "tokens": TRAIN_TOKENS, "dtype": "bfloat16",
                      "kernels": curves["kernels"],
                      "composed": curves["composed"], "max_rel": max(rel),
                      "rtol": rtol}), flush=True)
    if not all(math.isfinite(x) for c in curves.values() for x in c) \
            or not max(rel) <= rtol:
        fail(f"kernel and composed train steps disagree: {curves}")


def training_path(torch, tree, steps=5):
    """bench.py's bench_gpt_1p3b through the port: 1 warm-up + 4 timed
    steps. Returns (launch counts of the run, the train step, ids)."""
    import math
    from paddle_tpu_torch.models.gpt import GPTConfig
    from paddle_tpu_torch.observability.perf import gpt_train_flops_per_step
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    from paddle_tpu_torch.parallel import HybridParallelTrainStep
    cfg = GPTConfig.gpt3_1p3b(amp_dtype="bfloat16", attn_impl="flash",
                              remat=True)
    t0 = time.perf_counter()
    step = HybridParallelTrainStep(cfg, dp=1, pp=1, tp=1,
                                   grad_clip_norm=1.0, params=tree)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    ids = train_ids(cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = step(ids)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    counts = launch_counts()
    step_s = statistics.median(times[1:])
    flops = gpt_train_flops_per_step(cfg, 1, TRAIN_TOKENS)
    main = {"phase": "training_path", "config": "gpt3_1p3b bf16 flash "
            "remat dp=pp=tp=1 clip=1.0", "batch": 1, "seq": TRAIN_TOKENS,
            "losses": losses, "step_ms": [round(t * 1e3, 3) for t in times],
            "step_ms_median": round(step_s * 1e3, 3),
            "tokens_per_s": round(TRAIN_TOKENS / step_s, 2),
            "mfu_bf16": round(flops / step_s / BF16_FLOPS, 5),
            "flops_per_step": flops, "upload_s": round(upload_s, 2),
            "max_memory_allocated_gb": round(
                torch.cuda.max_memory_allocated() / 1e9, 3),
            "launches": counts}
    print(json.dumps(main), flush=True)
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"training loss did not fall: {losses}")
    missing = [k for k in TRAINING_KERNELS if counts.get(k, 0) <= 0]
    if missing:
        fail(f"kernels never launched on the training path: {missing} "
             f"(counts {counts})")
    return counts, step, ids


def kernel_entry(row, launches):
    return {"name": row["kernel"], "route": "cuda",
            "source": SOURCE[row["kernel"]],
            "replaces": REPLACES[row["kernel"]], "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"]}


def kernels_line(results, serve_counts, train_counts):
    """One entry per kernel at the shape of the path it serves, with
    that path's launch count: paged attention from the serving run
    (decode, f32 cache); the flash kernels and the sub-blocks from the
    training run (bf16, M = 1024), the sub-blocks with their serving
    decode numbers (f32, M = 8) nested under "serving"."""
    def row(name, key):
        return next(r for r in results
                    if r["kernel"] == name and key in r["shape"])

    kernels = [kernel_entry(row("paged_attention", "cache=f32"),
                            serve_counts.get("paged_attention", 0))]
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        kernels.append(kernel_entry(row(name, "bf16"),
                                    train_counts.get(name, 0)))
    for name in ("fused_out_ln", "fused_ffn_ln"):
        ent = kernel_entry(row(name, "bf16"), train_counts.get(name, 0))
        ent["serving"] = kernel_entry(row(name, "M=8 "),
                                      serve_counts.get(name, 0))
        kernels.append(ent)
    return {"kernels": kernels}


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
    from paddle_tpu_torch.models.gpt import (GPTConfig, disable_tf32,
                                             init_gpt_params)
    disable_tf32()
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
    check_blocks_bf16(torch, timer, results)
    check_flash(torch, timer, results)
    del timer
    torch.cuda.empty_cache()
    if kernels_only:
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return

    t0 = time.perf_counter()
    tree = init_gpt_params(GPTConfig.gpt3_1p3b(), seed=0)
    print(json.dumps({"phase": "weights", "config": "gpt3_1p3b", "seed": 0,
                      "init_s": round(time.perf_counter() - t0, 2)}),
          flush=True)

    serve_counts, eng = serving_path(torch, tree)
    if with_profile:
        profile_decode(torch, eng, eng.model.cfg.vocab_size)
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    train_parity(torch, tree)
    train_counts, step, ids = training_path(torch, tree)
    if with_profile:
        profile_steps(torch, lambda: step(ids), 1, "train_step", top_n=16)
    del step
    gc.collect()
    torch.cuda.empty_cache()

    print(json.dumps(kernels_line(results, serve_counts, train_counts)),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])

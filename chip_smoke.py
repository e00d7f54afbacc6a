"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # every phase (needs one CUDA card)
    python3 chip_smoke.py --kernels  # phases 1-2 only: build + check
    python3 chip_smoke.py --profile  # also: device-time breakdowns of
                                     # 10 decode steps, of one GPT train
                                     # step and of one BERT train step
                                     # (torch.profiler)

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
  6. BERT: the kernels at the shapes the BERT-base pretrain step gives
     them (phase 2b, run with the other kernel checks): layer norm and
     dropout + residual + layer norm, forward and backward, at R = 2048
     and R = 304 rows of C = 768, f32 and bf16, p = 0 and 0.1, with
     bit-equal dropout masks; the two sub-blocks at M = 2048 with
     dropout, post-norm and the erf-polynomial gelu; the three flash
     kernels at B=16, H=12, S=128, D=64, non-causal, with dropout, with
     and without a padding mask;
  7. BERT train parity — ``make_train_step`` on BERT-base cut to 2
     layers at full width, dropout 0.1, AMP O1, 3 steps with fixed
     seeds, through the kernels and through the composed chains
     (``nn.functional.composed_ops``) on the card: every step's loss
     must agree within 2e-2 relative;
  8. the BERT training path — bench.py's bench_bert configuration whole
     (BERT-base, batch 16 x 128, 19 masked positions a sequence, AdamW
     lr 1e-4, AMP O1, dropout 0.1), 1 warm-up + 4 timed steps: finite
     losses, the masked-LM term of the last below that of the first
     (the next-sentence term, 16 labels under Adam at lr 1e-4 without
     warm-up, overshoots and swings the sum by several nats from step to
     step), every kernel of the path launched as often as the model
     predicts; step ms, samples/s, tokens/s, MFU and peak device memory;
  9. the encoder-layer phase — one ``TransformerEncoderLayer(768, 12,
     3072)`` with the constructor's defaults (relu, act_dropout =
     dropout = 0.1, post-LN), forward and backward at (16, 128, 768),
     kernels against composed chains; this is the route that launches
     the dropout + residual + layer norm kernels;
 10. the kernels line, then the card line, then the result line.

One numpy weight tree (seed 0, 1.3 B parameters) feeds phases 3-5; the
BERT phases draw their weights from the port's seeded initialisers.
Any failed phase exits non-zero before the result line.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
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
LN_SRC = "paddle_tpu_torch/ops/csrc/layer_norm.cu"
DAL_SRC = "paddle_tpu_torch/ops/csrc/fused_residual.cu"
FFN_SRC = "paddle_tpu_torch/ops/csrc/fused_ffn.cu"
SOURCE = {"fused_ffn": FFN_SRC, "paged_attention": PAGED_SRC, "fused_out_ln": BLOCK_SRC,
          "fused_ffn_ln": BLOCK_SRC, "flash_fwd": FLASH_SRC,
          "flash_bwd_dq": FLASH_SRC, "flash_bwd_dkv": FLASH_SRC,
          "layer_norm_fwd": LN_SRC, "layer_norm_bwd_dx": LN_SRC,
          "dropout_add_ln_fwd": DAL_SRC, "dropout_add_ln_bwd": DAL_SRC}
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
    "layer_norm_fwd": "paddle_tpu/ops/pallas_layer_norm.py:51 _fwd_kernel "
                      "(_ln_fwd_impl :87, pallas_call :90)",
    "layer_norm_bwd_dx": "paddle_tpu/ops/pallas_layer_norm.py:66 "
                         "_bwd_dx_kernel (_ln_bwd :117, pallas_call :124)",
    "dropout_add_ln_fwd": "paddle_tpu/ops/pallas_fused_residual.py:68 "
                          "_fwd_kernel (_fwd_impl :133, pallas_call :136)",
    "dropout_add_ln_bwd": "paddle_tpu/ops/pallas_fused_residual.py:91 "
                          "_bwd_kernel (_vjp_bwd :169, pallas_call :175)",
    "fused_ffn": "paddle_tpu/ops/pallas_ffn.py:124 _ffn_kernel "
                 "(_ffn_fwd_impl :143, pallas_call :148)",
}
SERVING_KERNELS = ("paged_attention", "fused_out_ln", "fused_ffn_ln")
TRAINING_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                    "fused_out_ln", "fused_ffn_ln")
TRAIN_TOKENS = 1024
# bench.py's bench_bert: BERT-base, batch 16 x 128, 19 masked positions
BERT_BATCH, BERT_SEQ = 16, 128
BERT_PRED = min(BERT_SEQ, max(8, int(round(BERT_SEQ * 0.15))))
BERT_LAYERS = 12
# launches of one BERT-base train step (no remat; the sub-blocks' backward
# is the composed recompute; LN: embeddings and MLM head)
BERT_LAUNCHES_PER_STEP = {
    "fused_out_ln": BERT_LAYERS, "fused_ffn_ln": BERT_LAYERS,
    "flash_fwd": BERT_LAYERS, "flash_bwd_dq": BERT_LAYERS,
    "flash_bwd_dkv": BERT_LAYERS, "layer_norm_fwd": 2,
    "layer_norm_bwd_dx": 2}
# the encoder layer with the constructor's defaults, forward + backward
ENCODER_LAYER_LAUNCHES = {
    "dropout_add_ln_fwd": 1, "dropout_add_ln_bwd": 1, "fused_out_ln": 1,
    "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
# the static FFN program: ops/autobench.py's bert_base_512 preset shape
FFN_M, FFN_H, FFN_I = 8192, 768, 3072
FFN_STEPS = 5
# fused_ffn launches of one static FFN step: the forward op, and the
# forward re-run inside fused_ffn_grad (the auto grad differentiates the
# op's compute)
FFN_LAUNCHES_PER_STEP = 2
# bench.py's bench_lenet
LENET_BATCH, LENET_STEPS = 256, 30


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

    def queued(self, fns, reps: int = 5) -> float:
        """Median device time per call, in ms, of the calls in `fns` run
        back to back. For kernels of a few microseconds the wrapper's
        host time (allocations, ctypes) is longer than the kernel, and
        an event pair around one launch times the host. Here a ~2 ms
        spin kernel holds the stream while the host enqueues every call
        behind it, then the L2 flush, the start event, the calls and the
        end event drain at the device's own pace. Each call works on its
        own buffers, so after the flush every one finds its inputs cold
        (as far as the sets together exceed what L2 would keep)."""
        torch = self.torch
        for fn in fns[:2]:
            fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            torch.cuda._sleep(4_000_000)
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            for fn in fns:
                fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e) / len(fns))
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


def check_rows(torch, timer, results):
    """Layer norm and dropout + residual + layer norm, forward and
    backward, at the BERT-base shapes: R = 2048 tokens and R = 16 * 19 =
    304 masked positions, C = 768, eps 1e-12, f32 (the training path's
    type under AMP O1, where layer_norm is on the black list) and bf16.
    Tolerances: f32 |err| <= 1e-4 + 1e-4 |ref| (row sums in another
    order, rsqrtf against rsqrt); bf16 2e-2 + 2e-2 |ref| (f32 arithmetic
    on the same bf16 numbers, one rounding of each output); statistics
    1e-4. The dropout masks must be bit-equal: dx is zero exactly where
    keep_mask dropped. Times are Timer.queued over 16 sets of buffers:
    these kernels run for microseconds, less than their wrappers' host
    time."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import fused_residual as fr
    from paddle_tpu_torch.ops import layer_norm as ln
    C, eps, seed = 768, 1e-12, 20240917
    g = torch.Generator(device="cuda").manual_seed(4)
    s = 1.0 + 0.1 * torch.randn(C, generator=g, device="cuda")
    b = 0.1 * torch.randn(C, generator=g, device="cuda")
    for name, dt, t in (("f32", torch.float32, 1e-4),
                        ("bf16", torch.bfloat16, 2e-2)):
        tol = {"atol": t, "rtol": t}
        item = 2 if dt == torch.bfloat16 else 4
        for R in (2048, 304):
            x, res, dy = (torch.randn(R, C, generator=g, device="cuda")
                          .to(dt) for _ in range(3))
            shape = f"R={R} C={C} {name}"
            sl, bl = s.to(dt), b.to(dt)
            sets = range(16)
            xs, rs, dys = ([t.clone() for _ in sets] for t in (x, res, dy))

            def each(fn):
                return timer.queued([lambda i=i: fn(i) for i in sets])

            y, mean, rstd = ln._fwd_kernel(x, s, b, eps)
            y_r, mean_r, rstd_r = ln.layer_norm_reference(x, s, b, eps)
            torch.cuda.synchronize()
            bms, by = bound(2 * R * C * item + 8 * C + 8 * R, 8 * R * C)
            row = {"kernel": "layer_norm_fwd", "shape": shape,
                   "max_abs_err": max_err(y, y_r), "tol": tol,
                   "kernel_ms": each(lambda i: ln._fwd_kernel(xs[i], s, b,
                                                              eps)),
                   "plain_ms": each(lambda i: ln.layer_norm_reference(
                       xs[i], s, b, eps)),
                   "library_ms": each(lambda i: F.layer_norm(
                       xs[i], (C,), sl, bl, eps)),
                   "bound_ms": bms, "bound_by": by}
            report(results, row, within(y, y_r, **tol)
                   and within(mean, mean_r, 1e-4, 1e-4)
                   and within(rstd, rstd_r, 1e-4, 1e-4))

            dx = ln._bwd_dx_kernel(x, s, mean, rstd, dy)
            dx_r = ln.layer_norm_bwd_dx_reference(x, s, mean, rstd, dy)
            torch.cuda.synchronize()
            bms, by = bound(3 * R * C * item + 4 * C + 8 * R, 11 * R * C)
            # the library's backward takes its own forward's statistics
            _, m2, r2 = torch.native_layer_norm(x, [C], sl, bl, eps)
            row = {"kernel": "layer_norm_bwd_dx", "shape": shape,
                   "max_abs_err": max_err(dx, dx_r), "tol": tol,
                   "kernel_ms": each(lambda i: ln._bwd_dx_kernel(
                       xs[i], s, mean, rstd, dys[i])),
                   "plain_ms": each(
                       lambda i: ln.layer_norm_bwd_dx_reference(
                           xs[i], s, mean, rstd, dys[i])),
                   "library_ms": each(
                       lambda i: torch.ops.aten.native_layer_norm_backward(
                           dys[i], xs[i], [C], m2, r2, sl, bl,
                           [True, False, False])),
                   "bound_ms": bms, "bound_by": by}
            report(results, row, within(dx, dx_r, **tol))

            for p in (0.0, 0.1):
                pshape = f"{shape} p={p}"
                y, z, mean, rstd = fr._fwd_kernel(x, res, s, b, seed, p, eps)
                y_r, z_r, mean_r, rstd_r = fr.dropout_add_ln_reference(
                    x, res, s, b, seed, p, eps)
                torch.cuda.synchronize()
                bms, by = bound(4 * R * C * item + 8 * C + 8 * R,
                                10 * R * C)
                row = {"kernel": "dropout_add_ln_fwd", "shape": pshape,
                       "max_abs_err": max(max_err(y, y_r), max_err(z, z_r)),
                       "tol": tol,
                       "kernel_ms": each(lambda i: fr._fwd_kernel(
                           xs[i], rs[i], s, b, seed, p, eps)),
                       "plain_ms": each(
                           lambda i: fr.dropout_add_ln_reference(
                               xs[i], rs[i], s, b, seed, p, eps)),
                       "library_ms": each(lambda i: F.layer_norm(
                           rs[i] + F.dropout(xs[i], p), (C,), sl, bl,
                           eps)),
                       "bound_ms": bms, "bound_by": by}
                report(results, row, within(y, y_r, **tol)
                       and within(z, z_r, **tol)
                       and within(mean, mean_r, 1e-4, 1e-4)
                       and within(rstd, rstd_r, 1e-4, 1e-4))

                zs = [z.clone() for _ in sets]
                dx, dres = fr._bwd_kernel(z, s, mean, rstd, dy, seed, p)
                dx_r, dres_r = fr.dropout_add_ln_bwd_reference(
                    z, s, mean, rstd, dy, seed, p)
                torch.cuda.synchronize()
                masks_equal = True
                if p > 0:
                    keep = fr.keep_mask(seed, R, C, p, "cuda")
                    masks_equal = bool(torch.equal(dx != 0,
                                                   keep & (dres != 0)))
                bms, by = bound(4 * R * C * item + 4 * C + 8 * R,
                                13 * R * C)
                row = {"kernel": "dropout_add_ln_bwd", "shape": pshape,
                       "max_abs_err": max(max_err(dx, dx_r),
                                          max_err(dres, dres_r)),
                       "tol": tol, "masks_bit_equal": masks_equal,
                       "kernel_ms": each(lambda i: fr._bwd_kernel(
                           zs[i], s, mean, rstd, dys[i], seed, p)),
                       "plain_ms": each(
                           lambda i: fr.dropout_add_ln_bwd_reference(
                               zs[i], s, mean, rstd, dys[i], seed, p)),
                       "library_ms": None,
                       "bound_ms": bms, "bound_by": by}
                report(results, row, masks_equal
                       and within(dx, dx_r, **tol)
                       and within(dres, dres_r, **tol))


def check_blocks_bert(torch, timer, results):
    """The sub-blocks as the BERT-base step launches them: M = 2048
    tokens, D = H = 768, I = 3072, dropout 0.1, eps 1e-12; fused_ffn_ln
    with the erf-polynomial gelu and post-norm. f32 is the path's type
    (AMP O1 leaves both block ops off its lists, so they see f32 weights
    and residuals); bf16 beside it. Tolerances as in check_blocks /
    check_blocks_bf16, the f32 one widened to 2e-4 for the division by
    1 - p and the I = 3072 sums. A zero residual exposes the mask: z is
    zero exactly where keep_mask dropped."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.fused_block import (
        ffn_ln_reference, fused_ffn_ln, fused_out_ln, out_ln_reference)
    from paddle_tpu_torch.ops.fused_residual import keep_mask
    M, D, I, p, eps, seed = BERT_BATCH * BERT_SEQ, 768, 3072, 0.1, 1e-12, 77
    g = torch.Generator(device="cuda").manual_seed(5)
    for name, dt, peak, tol in (
            ("f32", torch.float32, F32_FLOPS, {"atol": 2e-4, "rtol": 2e-4}),
            ("bf16", torch.bfloat16, BF16_FLOPS,
             {"atol": 2e-2, "rtol": 2e-2})):
        item = 2 if dt == torch.bfloat16 else 4

        def rn(*shape, s=1.0, dt=dt):
            return (torch.randn(*shape, generator=g, device="cuda")
                    * s).to(dt)

        w, b = rn(D, D, s=0.02), rn(D, s=0.02)
        ln_s = rn(D, s=0.1, dt=torch.float32) + 1.0
        ln_b = rn(D, s=0.1, dt=torch.float32)
        w1, b1 = rn(D, I, s=0.02), rn(I, s=0.02)
        w2, b2 = rn(I, D, s=0.02), rn(D, s=0.02)
        a, res, x = rn(M, D), rn(M, D), rn(M, D)
        ls, lb = ln_s.to(dt), ln_b.to(dt)

        args = (a, w, b, res, ln_s, ln_b, p, eps, seed)
        z, h = fused_out_ln(*args)
        zr, hr = out_ln_reference(*args)
        z0, _ = fused_out_ln(a, w, b, torch.zeros_like(res), ln_s, ln_b, p,
                             eps, seed)
        torch.cuda.synchronize()
        masks_equal = bool(torch.equal(z0 != 0,
                                       keep_mask(seed, M, D, p, "cuda")))
        bms, by = bound(item * (M * D + D * D + D + M * D + 2 * M * D)
                        + 8 * D, 2 * M * D * D + 12 * M * D, peak)

        def lib_out():
            zz = F.dropout(torch.addmm(b, a, w), p).add_(res)
            return F.layer_norm(zz, (D,), ls, lb, eps)

        row = {"kernel": "fused_out_ln",
               "shape": f"M={M} D={D} {name} p={p} (BERT)",
               "max_abs_err": max(max_err(z, zr), max_err(h, hr)),
               "tol": tol, "masks_bit_equal": masks_equal,
               "kernel_ms": timer(lambda: fused_out_ln(*args)),
               "plain_ms": timer(lambda: out_ln_reference(*args)),
               "library_ms": timer(lib_out), "bound_ms": bms,
               "bound_by": by}
        report(results, row, masks_equal and within(z, zr, **tol)
               and within(h, hr, **tol))

        fargs = (x, w1, b1, w2, b2, res, ln_s, ln_b, "gelu", "post", p, eps,
                 seed)
        out = fused_ffn_ln(*fargs)
        ref = ffn_ln_reference(*fargs)
        torch.cuda.synchronize()
        bms, by = bound(item * (M * D + D * I + I + I * D + D + 2 * M * D)
                        + 8 * D, 4 * M * D * I + 25 * M * I + 12 * M * D,
                        peak)

        def lib_ffn():
            u = F.gelu(torch.addmm(b1, x, w1))
            zz = F.dropout(torch.addmm(b2, u, w2), p).add_(res)
            return F.layer_norm(zz, (D,), ls, lb, eps)

        row = {"kernel": "fused_ffn_ln",
               "shape": f"M={M} H={D} I={I} {name} gelu post p={p} (BERT; "
               f"partial sums {I // 128 * M * D * 4 / 1e6:.0f} MB)",
               "max_abs_err": max_err(out, ref), "tol": tol,
               "kernel_ms": timer(lambda: fused_ffn_ln(*fargs)),
               "plain_ms": timer(lambda: ffn_ln_reference(*fargs)),
               "library_ms": timer(lib_ffn), "bound_ms": bms,
               "bound_by": by}
        report(results, row, within(out, ref, **tol))


def check_flash_bert(torch, timer, results):
    """The three flash kernels as the BERT-base step launches them:
    B=16, H=12, S=T=128, D=64, non-causal, dropout 0.1, in bf16 (the
    path's type: fused_attention is on the O1 white list) and f32, with
    and without a padding mask (B, 1, 1, T) whose rows pad 0..45 trailing
    keys. Tolerances as in check_flash. Two identity-block V's expose the
    dropout mask bit for bit."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import flash_attention as fa
    B, H, T, D, p, seed = BERT_BATCH, 12, BERT_SEQ, 64, 0.1, 4242
    BH = B * H
    scale = D ** -0.5
    g = torch.Generator(device="cuda").manual_seed(6)
    pad = torch.zeros(B, T, device="cuda")
    for i in range(B):
        pad[i, T - 3 * i:] = -1e9 if i else 0.0
    n_el = BH * T * T
    for name, dt, peak, t in (("bf16", torch.bfloat16, BF16_FLOPS, 2e-2),
                              ("f32", torch.float32, F32_FLOPS, 1e-4)):
        tol = {"atol": t, "rtol": t}
        q, k, v, do = (torch.randn(BH, T, D, generator=g, device="cuda")
                       .to(dt) for _ in range(4))
        item = q.element_size()
        q4, k4, v4, do4 = (a.reshape(B, H, T, D) for a in (q, k, v, do))

        # the mask bit for bit: o = dropped P when V is an identity block
        keep = fa.keep_mask_salted(seed, BH, T, T, p, "cuda")
        masks_equal = True
        for half in (0, 1):
            vi = torch.zeros(BH, T, D, device="cuda", dtype=dt)
            vi[:, half * D:(half + 1) * D] = torch.eye(D, device="cuda")
            oi, _ = fa._fwd_kernel(q * 0.2, k * 0.2, vi, scale, False, None,
                                   seed, p)
            masks_equal &= bool(torch.equal(
                oi != 0, keep[:, :, half * D:(half + 1) * D]))
        del keep

        for mask2, mname in ((None, "no mask"), (pad, "padding mask")):
            shape = f"B={B} H={H} S=T={T} D={D} {name} p={p} {mname} (BERT)"
            tail = (scale, False, mask2, seed, p)
            mask4 = None if mask2 is None else mask2[:, None, None, :].to(dt)
            o, lse = fa._fwd_kernel(q, k, v, *tail)
            o_r, lse_r = fa.flash_fwd_reference(q, k, v, *tail)
            torch.cuda.synchronize()
            mbytes = 0 if mask2 is None else 4 * B * T
            bms, by = bound(item * 4 * BH * T * D + 4 * BH * T + mbytes,
                            4 * D * n_el, peak)
            row = {"kernel": "flash_fwd", "shape": shape,
                   "max_abs_err": max(max_err(o, o_r), max_err(lse, lse_r)),
                   "tol": tol, "masks_bit_equal": masks_equal,
                   "kernel_ms": timer(lambda: fa._fwd_kernel(q, k, v,
                                                             *tail)),
                   "plain_ms": timer(lambda: fa.flash_fwd_reference(
                       q, k, v, *tail)),
                   "library_ms": timer(
                       lambda: F.scaled_dot_product_attention(
                           q4, k4, v4, attn_mask=mask4, dropout_p=p)),
                   "bound_ms": bms, "bound_by": by}
            report(results, row, masks_equal and within(o, o_r, **tol)
                   and within(lse, lse_r, 1e-4, 1e-4))

            ql, kl, vl = (a.detach().clone().requires_grad_()
                          for a in (q4, k4, v4))

            def lib_bwd():
                out = F.scaled_dot_product_attention(
                    ql, kl, vl, attn_mask=mask4, dropout_p=p)
                return torch.autograd.grad(out, (ql, kl, vl), do4)

            lib_ms = timer(lib_bwd)
            delta = fa.bwd_delta(o, do)
            args = (q, k, v, do, lse, delta, *tail)
            plain_args = (q, k, v, o, lse, do, *tail)
            dq = fa._dq_kernel(*args)
            dq_r = fa.bwd_dq_reference(*plain_args)
            torch.cuda.synchronize()
            bms, by = bound(item * 5 * BH * T * D + 8 * BH * T + mbytes,
                            6 * D * n_el, peak)
            row = {"kernel": "flash_bwd_dq", "shape": shape,
                   "max_abs_err": max_err(dq, dq_r), "tol": tol,
                   "kernel_ms": timer(lambda: fa._dq_kernel(*args)),
                   "plain_ms": timer(lambda: fa.bwd_dq_reference(
                       *plain_args)),
                   "library_ms": lib_ms, "bound_ms": bms, "bound_by": by}
            report(results, row, within(dq, dq_r, **tol))

            dk, dv = fa._dkv_kernel(*args)
            dk_r, dv_r = fa.bwd_dkv_reference(*plain_args)
            torch.cuda.synchronize()
            bms, by = bound(item * 6 * BH * T * D + 8 * BH * T + mbytes,
                            8 * D * n_el, peak)
            row = {"kernel": "flash_bwd_dkv", "shape": shape,
                   "max_abs_err": max(max_err(dk, dk_r), max_err(dv, dv_r)),
                   "tol": tol,
                   "kernel_ms": timer(lambda: fa._dkv_kernel(*args)),
                   "plain_ms": timer(lambda: fa.bwd_dkv_reference(
                       *plain_args)),
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
    time; beside them, the port's own launch counters over the same calls
    (a kernel the profiler lists fewer times than its wrapper counted is
    missing from the busy time). One more call runs first under the
    profiler's warm-up, traced and dropped: a trace that starts cold
    loses its first kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    from paddle_tpu_torch.observability import TRACER
    from paddle_tpu_torch.ops import launch_counts
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        run()
        torch.cuda.synchronize()
        prof.step()
        before = launch_counts()
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counted = {k: (v - before.get(k, 0)) / steps
               for k, v in launch_counts().items() if v != before.get(k, 0)}
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
                        for k, v in top],
        "port_launches_per_step": counted}), flush=True)


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


def bert_batch(vocab: int):
    """bench.py's bench_bert batch: ids, masked positions, MLM labels and
    NSP labels from np.random.RandomState(0)."""
    import numpy as np
    rng = np.random.RandomState(0)
    ids = rng.randint(4, vocab, (BERT_BATCH, BERT_SEQ)).astype("int64")
    pos = np.stack([np.sort(rng.choice(BERT_SEQ, BERT_PRED, replace=False))
                    for _ in range(BERT_BATCH)]).astype("int64")
    mlm = np.take_along_axis(ids, pos, axis=1)
    nsp = rng.randint(0, 2, (BERT_BATCH, 1)).astype("int64")
    return ids, pos, mlm, nsp


def bert_loss_fn(m, ids, pos, mlm, nsp):
    logits, nsp_logits = m(ids, masked_positions=pos)
    return m.loss(logits, nsp_logits, mlm, nsp)


def bert_model(layers: int, seed: int = 0):
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.nn import initializer
    initializer.seed(seed)
    cfg = BertConfig.base(num_hidden_layers=layers)
    model = BertForPretraining(cfg)
    model.train()
    return cfg, model


def bert_parity(torch, layers=2, steps=3, rtol=2e-2):
    """The BERT train step through the kernels against the same step
    through the composed chains (the plain versions under autograd) on
    the card: BERT-base cut to `layers` layers at full width, dropout
    0.1, AMP O1, the same weights, batch and step seeds, so both sides
    drop the same elements. The sub-block ops run in f32 on both sides
    and attention in bf16, where the kernels keep P in f32 and the
    composed chain rounds it to bf16: the curves agree to bf16
    precision, within `rtol` relative."""
    import math
    from paddle_tpu_torch.jit import make_train_step
    from paddle_tpu_torch.nn import functional as F
    curves = {}
    for name in ("kernels", "composed"):
        cfg, model = bert_model(layers)
        step = make_train_step(model, bert_loss_fn, optimizer="adamw",
                               lr=1e-4, amp_level="O1")
        batch = bert_batch(cfg.vocab_size)
        with F.composed_ops(name == "composed"):
            curves[name] = [float(step(*batch, seed=100 + i))
                            for i in range(steps)]
        del step, model
        torch.cuda.empty_cache()
    rel = [abs(a - b) / abs(b) for a, b in zip(curves["kernels"],
                                                curves["composed"])]
    print(json.dumps({"phase": "bert_parity", "layers": layers,
                      "batch": BERT_BATCH, "seq": BERT_SEQ, "amp": "O1",
                      "dropout": 0.1, "kernels": curves["kernels"],
                      "composed": curves["composed"], "max_rel": max(rel),
                      "rtol": rtol}), flush=True)
    if not all(math.isfinite(x) for c in curves.values() for x in c) \
            or not max(rel) <= rtol:
        fail(f"kernel and composed BERT train steps disagree: {curves}")


def bert_training_path(torch, steps=5):
    """bench.py's bench_bert through the port: 1 warm-up + 4 timed
    steps. Returns (launch counts of the run, the train step, batch).

    The loss is the sum of the masked-LM term (304 predictions over a
    30522-word vocabulary, ln V = 10.3 at the start) and the
    next-sentence term (16 two-way labels). At lr 1e-4 without warm-up
    Adam's first steps move every weight by 1e-4 in the gradient's sign,
    which overshoots on the 16 next-sentence labels: that term swings
    between 0.2 and 4 nats from step to step (seen at 2 layers on the
    CPU too, in f32), while the masked-LM term falls steadily. So the
    sum must be finite at every step, and the check that the model
    learns is on the masked-LM term: the fifth step's below the
    first's."""
    import math
    from paddle_tpu_torch.jit import make_train_step
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.observability.perf import bert_train_flops_per_step
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    t0 = time.perf_counter()
    cfg, model = bert_model(BERT_LAYERS)
    init_s = time.perf_counter() - t0
    nsp_terms = []

    def loss_fn(m, ids, pos, mlm, nsp):
        logits, nsp_logits = m(ids, masked_positions=pos)
        with torch.no_grad():       # the sum's second term, for the record
            nsp_terms.append(F.cross_entropy(nsp_logits, nsp))
        return m.loss(logits, nsp_logits, mlm, nsp)

    step = make_train_step(model, loss_fn, optimizer="adamw", lr=1e-4,
                           amp_level="O1")
    batch = tuple(torch.as_tensor(a, device="cuda")
                  for a in bert_batch(cfg.vocab_size))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = step(*batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    counts = launch_counts()
    nsp_losses = [float(t) for t in nsp_terms]
    mlm_losses = [a - b for a, b in zip(losses, nsp_losses)]
    step_s = statistics.median(times[1:])
    flops = bert_train_flops_per_step(cfg, BERT_BATCH, BERT_SEQ, BERT_PRED)
    main = {"phase": "bert_training_path", "config": "bert_base O1 adamw "
            "lr=1e-4 dropout=0.1", "batch": BERT_BATCH, "seq": BERT_SEQ,
            "n_pred": BERT_PRED, "losses": losses,
            "mlm_losses": mlm_losses, "nsp_losses": nsp_losses,
            "step_ms": [round(t * 1e3, 3) for t in times],
            "step_ms_median": round(step_s * 1e3, 3),
            "samples_per_s": round(BERT_BATCH / step_s, 2),
            "tokens_per_s": round(BERT_BATCH * BERT_SEQ / step_s, 2),
            "mfu_bf16": round(flops / step_s / BF16_FLOPS, 5),
            "flops_per_step": flops, "init_s": round(init_s, 2),
            "max_memory_allocated_gb": round(
                torch.cuda.max_memory_allocated() / 1e9, 3),
            "launches": counts,
            "launches_predicted": {k: v * steps for k, v in
                                   BERT_LAUNCHES_PER_STEP.items()}}
    print(json.dumps(main), flush=True)
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite BERT training loss: {losses}")
    if not mlm_losses[-1] < mlm_losses[0]:
        fail(f"BERT masked-LM loss did not fall: {mlm_losses} (sums "
             f"{losses})")
    wrong = {k: (counts.get(k, 0), v * steps)
             for k, v in BERT_LAUNCHES_PER_STEP.items()
             if counts.get(k, 0) != v * steps}
    if wrong:
        fail(f"BERT path launches (got, predicted): {wrong}")
    return counts, step, batch


def encoder_layer_phase(torch):
    """One TransformerEncoderLayer(768, 12, 3072) with the constructor's
    defaults (relu, act_dropout = dropout = 0.1, post-LN) in training
    mode, forward and backward at (16, 128, 768) in f32: the activation
    dropout keeps the FFN off the one-kernel block, so its epilogue is
    the dropout + residual + layer norm kernel pair. Kernels against the
    composed chains under the same step seed: output and every gradient
    within 1e-3 + 1e-3 |ref| (f32 GEMMs of 768 and 3072 terms in other
    orders through the layer). Returns the run's launch counts."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn import initializer
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    initializer.seed(1)
    layer = nn.TransformerEncoderLayer(768, 12, 3072).to("cuda")
    layer.train()
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(BERT_BATCH, BERT_SEQ, 768, generator=g, device="cuda")
    dy = torch.randn(BERT_BATCH, BERT_SEQ, 768, generator=g, device="cuda")
    params = list(layer.parameters())

    def run():
        xr = x.clone().requires_grad_()
        with F.seed_scope(11):
            y = layer(xr)
        return [y.detach(), *torch.autograd.grad(y, [xr, *params], dy)]

    reset_launch_counts()
    t0 = time.perf_counter()
    got = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    with F.composed_ops():
        want = run()
    torch.cuda.synchronize()
    tol = {"atol": 1e-3, "rtol": 1e-3}
    names = ["y", "dx"] + [n for n, _ in layer.named_parameters()]
    errs = {n: max_err(a, b) for n, a, b in zip(names, got, want)}
    bad = [n for n, a, b in zip(names, got, want) if not within(a, b, **tol)]
    print(json.dumps({"phase": "encoder_layer", "config": "d_model=768 "
                      "nhead=12 ffn=3072 relu dropout=act_dropout=0.1 "
                      "post-LN f32", "shape": [BERT_BATCH, BERT_SEQ, 768],
                      "first_call_ms": round(wall * 1e3, 3),
                      "max_abs_err": max(errs.values()), "tol": tol,
                      "launches": counts}), flush=True)
    if bad:
        fail(f"encoder layer: kernels and composed chains disagree on "
             f"{bad}: {errs}")
    wrong = {k: (counts.get(k, 0), v)
             for k, v in ENCODER_LAYER_LAUNCHES.items()
             if counts.get(k, 0) != v}
    if wrong:
        fail(f"encoder layer launches (got, predicted): {wrong}")
    return counts


def check_ffn(torch, timer, results):
    """B row 10, ``ops.fused_ffn``, against its plain version: the
    bert_base_512 preset (M = 8192, H = 768, I = 3072), BERT-base's
    16 x 128 tokens (M = 2048) and GPT-3 XL width in bf16 (M = 1024,
    H = 2048, I = 8192), gelu and relu. Tolerance: f32 sums of 768 and
    3072 terms in other orders, |err| <= 1e-4 + 1e-4 |ref|; bf16 rounds
    hid and y once each in both (2**-8 relative), 2e-2 + 2e-2 |ref|. The
    library yardstick is addmm, the activation, addmm (cuBLAS, TF32 off
    for f32)."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.fused_ffn import ffn_reference, fused_ffn
    cases = [(FFN_M, FFN_H, FFN_I, torch.float32), (FFN_M, FFN_H, FFN_I,
                                                    torch.bfloat16),
             (2048, 768, 3072, torch.float32), (2048, 768, 3072,
                                                torch.bfloat16),
             (1024, 2048, 8192, torch.bfloat16)]
    g = torch.Generator(device="cuda").manual_seed(4)
    for M, H, I, dt in cases:
        def rn(*shape, sc=1.0):
            return (torch.randn(*shape, generator=g, device="cuda")
                    * sc).to(dt)
        x, w1, b1 = rn(M, H), rn(H, I, sc=0.02), rn(I, sc=0.02)
        w2, b2 = rn(I, H, sc=0.02), rn(H, sc=0.02)
        isz = 4 if dt == torch.float32 else 2
        tol = {"atol": 1e-4, "rtol": 1e-4} if dt == torch.float32 \
            else {"atol": 2e-2, "rtol": 2e-2}
        nbytes = isz * (M * H + H * I + I + I * H + H + M * H)
        bms, by = bound(nbytes, 4 * M * H * I + 10 * M * I,
                        F32_FLOPS if dt == torch.float32 else BF16_FLOPS)
        name = "f32" if dt == torch.float32 else "bf16"
        for act in ("gelu", "relu"):
            y = fused_ffn(x, w1, b1, w2, b2, act)
            ref = ffn_reference(x, w1, b1, w2, b2, act)
            again = fused_ffn(x, w1, b1, w2, b2, act)
            torch.cuda.synchronize()
            if not torch.equal(y, again):
                fail(f"fused_ffn M={M} {name} {act}: two runs differ")
            lib_act = (lambda u: F.gelu(u)) if act == "gelu" else torch.relu

            def lib():
                return torch.addmm(b2, lib_act(torch.addmm(b1, x, w1)), w2)

            row = {"kernel": "fused_ffn",
                   "shape": f"M={M} H={H} I={I} {name} {act}",
                   "max_abs_err": max_err(y, ref), "tol": tol,
                   "bit_identical_rerun": True,
                   "kernel_ms": timer(lambda: fused_ffn(x, w1, b1, w2, b2,
                                                        act)),
                   "plain_ms": timer(lambda: ffn_reference(x, w1, b1, w2,
                                                           b2, act)),
                   "library_ms": timer(lib), "bound_ms": bms,
                   "bound_by": by}
            report(results, row, within(y, ref, **tol))


def _lenet_batch(rng, protos, batch):
    """Class-separable digits, as tests/test_mnist_lenet.py makes them."""
    lab = rng.randint(0, 10, batch).astype("int64")
    img = protos[lab] + 0.3 * rng.randn(batch, 1, 28, 28).astype("float32")
    return {"img": img, "label": lab[:, None]}


def static_lenet_phase(torch, with_profile=False):
    """bench.py's bench_lenet through the port's static graph: the
    LeNet program of ``models.lenet.build_lenet_program`` with Adam 1e-3
    minimised, startup, one warm step and LENET_STEPS timed steps of
    batch 256 on ``Executor(CUDAPlace(0))``, fresh class-separable
    digits each step (host arrays fed as a user feeds them). The loss
    must fall and the accuracy rise; prints examples/s and the
    executor's counters."""
    import numpy as np
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.fluid import (CUDAPlace, Executor, Scope,
                                        framework, optimizer, scope_guard,
                                        unique_name)
    from paddle_tpu_torch.models.lenet import build_lenet_program
    pt.enable_static()
    try:
        with unique_name.guard():
            main, startup, feeds, fetches = build_lenet_program()
            with framework.program_guard(main, startup):
                optimizer.Adam(learning_rate=1e-3).minimize(fetches["loss"])
    finally:
        pt.disable_static()
    rng = np.random.RandomState(0)
    protos = rng.randn(10, 1, 28, 28).astype("float32")
    batches = [_lenet_batch(rng, protos, LENET_BATCH)
               for _ in range(LENET_STEPS + 1)]
    fetch = [fetches["loss"], fetches["acc"]]
    with scope_guard(Scope()):
        exe = Executor(CUDAPlace(0))
        exe.run(startup)
        lv, av = exe.run(main, feed=batches[0], fetch_list=fetch)
        losses, accs = [float(lv[0])], [float(av[0])]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [exe.run(main, feed=b, fetch_list=fetch, return_numpy=False)
                for b in batches[1:]]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if with_profile:
            profile_static(torch, exe, main, fetch, batches[0],
                           "static_lenet_step")
    losses += [float(o[0]) for o in outs]
    accs += [float(o[1]) for o in outs]
    main_d = {"phase": "static_lenet", "config": f"bench_lenet: batch {LENET_BATCH}, "
              "Adam 1e-3, separable digits", "ops_per_step":
              len(main.global_block().ops), "steps": LENET_STEPS,
              "step_ms": round(dt / LENET_STEPS * 1e3, 3),
              "examples_per_s": round(LENET_BATCH * LENET_STEPS / dt, 2),
              "losses": losses[::5] + [losses[-1]],
              "accs": accs[::5] + [accs[-1]], "executor": exe.stats()}
    print(json.dumps(main_d), flush=True)
    if not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < 0.5 * losses[0]:
        fail(f"static LeNet loss did not fall: {losses}")
    if not accs[-1] > accs[0]:
        fail(f"static LeNet accuracy did not rise: {accs}")


def build_ffn_program(H, I, act="gelu"):
    """The static FFN program: x, t data; W1, B1, W2, B2 parameters;
    y = run_op("fused_ffn"); loss = mean((y - t) * (y - t)); Adam 1e-3
    minimised. Returns (main, startup, loss)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.common_ops import run_op
    from paddle_tpu_torch.fluid import (framework, layers, optimizer,
                                        unique_name)
    pt.enable_static()
    try:
        with unique_name.guard():
            main, startup = framework.Program(), framework.Program()
            with framework.program_guard(main, startup):
                x = layers.data("x", [-1, H], "float32")
                t = layers.data("t", [-1, H], "float32")
                w1 = layers.create_parameter([H, I], "float32")
                b1 = layers.create_parameter([I], "float32", is_bias=True)
                w2 = layers.create_parameter([I, H], "float32")
                b2 = layers.create_parameter([H], "float32", is_bias=True)
                y = run_op("fused_ffn", {"X": x, "W1": w1, "B1": b1,
                                         "W2": w2, "B2": b2},
                           {"activation": act})
                d = y - t
                loss = layers.mean(d * d)
                optimizer.Adam(learning_rate=1e-3).minimize(loss)
    finally:
        pt.disable_static()
    return main, startup, loss


def static_ffn_phase(torch, with_profile=False):
    """The static FFN program at the preset shape (M = 8192, H = 768,
    I = 3072, gelu, f32) on the card: startup, then 1 + 4 Adam steps on
    one batch whose target is a fixed map of x (t = tanh(x A), A from a
    seed). The loss must fall; fused_ffn must launch FFN_LAUNCHES_PER_STEP
    times a step; the same steps from the same start under
    ``composed_ops()`` (the op's composed fallback, exact gelu) must give
    losses within 1e-3 relative; and one eager ``run_op("fused_ffn")``
    must launch the kernel once and agree with the plain version.
    Returns the kernel run's launch counts."""
    from paddle_tpu_torch import common_ops
    from paddle_tpu_torch.fluid import CUDAPlace, Executor, Scope, scope_guard
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    from paddle_tpu_torch.ops.fused_ffn import ffn_reference
    main, startup, loss = build_ffn_program(FFN_H, FFN_I)
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(FFN_M, FFN_H, generator=g, device="cuda")
    A = torch.randn(FFN_H, FFN_H, generator=g, device="cuda") / FFN_H ** 0.5
    feed = {"x": x, "t": torch.tanh(x @ A)}
    scope = Scope()
    with scope_guard(scope):
        exe = Executor(CUDAPlace(0))
        exe.run(startup)
    start = {n: scope.find_var(n).clone() for n in scope.local_var_names()}

    def train():
        sc = Scope()
        for n, v in start.items():
            sc.set(n, v.clone())
        out, times = [], []
        with scope_guard(sc):
            for _ in range(FFN_STEPS):
                t0 = time.perf_counter()
                lv = exe.run(main, feed=feed, fetch_list=[loss],
                             return_numpy=False)[0]
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                out.append(float(lv[0]))
        return out, times, sc

    torch.cuda.synchronize()
    reset_launch_counts()
    losses, times, sc = train()
    counts = launch_counts()
    with F.composed_ops():
        reset_launch_counts()
        composed, ctimes, _ = train()
        composed_counts = launch_counts()
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, composed))
    reset_launch_counts()
    w = {n: sc.find_var(n) for n in ("create_parameter_0.w_0",
                                     "create_parameter_1.b_0",
                                     "create_parameter_2.w_0",
                                     "create_parameter_3.b_0")}
    ws = list(w.values())
    y = common_ops.run_op("fused_ffn", {"X": x, "W1": ws[0], "B1": ws[1],
                                        "W2": ws[2], "B2": ws[3]},
                          {"activation": "gelu"})
    yr = ffn_reference(x, *ws, "gelu")
    torch.cuda.synchronize()
    eager = launch_counts().get("fused_ffn", 0)
    eager_err = max_err(y, yr)
    step_s = statistics.median(times[1:])
    flops = 3 * 4 * FFN_M * FFN_H * FFN_I
    print(json.dumps({
        "phase": "static_ffn", "config": f"M={FFN_M} H={FFN_H} I={FFN_I} "
        "gelu f32, Adam 1e-3, loss mean((y - t)^2)",
        "ops": [op.type for op in main.global_block().ops],
        "losses": losses, "composed_losses": composed, "max_rel": rel,
        "step_ms": [round(t * 1e3, 3) for t in times],
        "step_ms_median": round(step_s * 1e3, 3),
        "composed_step_ms_median": round(statistics.median(ctimes[1:])
                                         * 1e3, 3),
        "tokens_per_s": round(FFN_M / step_s, 2),
        "tflops_per_s_model": round(flops / step_s / 1e12, 3),
        "launches": counts, "launches_predicted": {
            "fused_ffn": FFN_LAUNCHES_PER_STEP * FFN_STEPS},
        "composed_launches": composed_counts,
        "eager_run_op": {"launches": eager, "max_abs_err": eager_err},
        "executor": exe.stats()}), flush=True)
    if not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < losses[0]:
        fail(f"static FFN loss did not fall: {losses}")
    if counts.get("fused_ffn", 0) != FFN_LAUNCHES_PER_STEP * FFN_STEPS:
        fail(f"static FFN: fused_ffn launched {counts.get('fused_ffn', 0)} "
             f"times, predicted {FFN_LAUNCHES_PER_STEP * FFN_STEPS}")
    if composed_counts.get("fused_ffn", 0) != 0:
        fail(f"composed_ops() still launched fused_ffn: {composed_counts}")
    if not rel <= 1e-3:
        fail(f"static FFN kernel and composed losses differ: {losses} "
             f"against {composed}")
    if eager != 1 or not within(y, yr, 1e-4, 1e-4):
        fail(f"eager run_op fused_ffn: {eager} launches, err {eager_err}")
    if with_profile:
        with scope_guard(sc):
            profile_static(torch, exe, main, [loss], feed, "static_ffn_step")
    return counts


def profile_static(torch, exe, main, fetch, feed, what, steps=3):
    """Device-time breakdown of `steps` static steps."""
    profile_steps(torch, lambda: exe.run(main, feed=feed, fetch_list=fetch,
                                         return_numpy=False), steps, what,
                  top_n=12)


def kernel_entry(row, launches):
    return {"name": row["kernel"], "route": "cuda",
            "source": SOURCE[row["kernel"]],
            "replaces": REPLACES[row["kernel"]], "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"]}


def kernels_line(results, serve_counts, train_counts, bert_counts,
                 layer_counts, ffn_counts):
    """One entry per kernel at the shape of the path it serves, with
    that path's launch count: paged attention from the serving run
    (decode, f32 cache); the flash kernels and the sub-blocks from the
    GPT training run (bf16, M = 1024), the sub-blocks with their serving
    decode numbers (f32, M = 8) nested under "serving", and all five
    with their BERT-shape numbers and the BERT run's launches nested
    under "bert"; the layer-norm kernels from the BERT run (f32,
    R = 2048); the dropout + residual + layer norm kernels from the
    encoder-layer phase (f32, R = 2048, p = 0.1); fused_ffn from the
    static FFN program (f32, gelu, M = 8192), its other shapes nested
    under "shapes" with launches null."""
    def row(name, *keys):
        return next(r for r in results if r["kernel"] == name
                    and all(k in r["shape"] for k in keys))

    kernels = [kernel_entry(row("paged_attention", "cache=f32"),
                            serve_counts.get("paged_attention", 0))]
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        ent = kernel_entry(row(name, "causal bf16"),
                           train_counts.get(name, 0))
        ent["bert"] = kernel_entry(row(name, "bf16", "no mask (BERT)"),
                                   bert_counts.get(name, 0))
        kernels.append(ent)
    for name in ("fused_out_ln", "fused_ffn_ln"):
        ent = kernel_entry(row(name, f"M={TRAIN_TOKENS} ", "bf16"),
                           train_counts.get(name, 0))
        ent["serving"] = kernel_entry(row(name, "M=8 "),
                                      serve_counts.get(name, 0))
        ent["bert"] = kernel_entry(row(name, "f32", "(BERT"),
                                   bert_counts.get(name, 0))
        kernels.append(ent)
    for name in ("layer_norm_fwd", "layer_norm_bwd_dx"):
        kernels.append(kernel_entry(row(name, "R=2048", "f32"),
                                    bert_counts.get(name, 0)))
    for name in ("dropout_add_ln_fwd", "dropout_add_ln_bwd"):
        kernels.append(kernel_entry(row(name, "R=2048", "f32", "p=0.1"),
                                    layer_counts.get(name, 0)))
    main = f"M={FFN_M} H={FFN_H} I={FFN_I} f32 gelu"
    ent = kernel_entry(row("fused_ffn", main), ffn_counts.get("fused_ffn", 0))
    # no path runs the other shapes: their launches were not counted
    ent["shapes"] = [kernel_entry(r, None) for r in results
                     if r["kernel"] == "fused_ffn" and r["shape"] != main]
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
    check_rows(torch, timer, results)
    check_blocks_bert(torch, timer, results)
    check_flash_bert(torch, timer, results)
    check_ffn(torch, timer, results)
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

    bert_parity(torch)
    bert_counts, bstep, bbatch = bert_training_path(torch)
    if with_profile:
        profile_steps(torch, lambda: bstep(*bbatch), 1, "bert_train_step",
                      top_n=24)
    del bstep, bbatch
    gc.collect()
    torch.cuda.empty_cache()
    layer_counts = encoder_layer_phase(torch)
    gc.collect()
    torch.cuda.empty_cache()

    static_lenet_phase(torch, with_profile)
    ffn_counts = static_ffn_phase(torch, with_profile)

    print(json.dumps(kernels_line(results, serve_counts, train_counts,
                                  bert_counts, layer_counts, ffn_counts)),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])

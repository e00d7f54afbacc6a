"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # every phase (needs one CUDA card)
    python3 chip_smoke.py --kernels  # phases 1-2 only: build + check
    python3 chip_smoke.py --profile  # also: device-time breakdowns of
                                     # 10 decode steps, of one GPT train
                                     # step, of one BERT train step, of
                                     # three steps of each static
                                     # program, of one ResNet-50
                                     # train step and of three
                                     # wide&deep steps (torch.profiler)

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
     larger): paged attention (the split-context kernel, f32 and bf16
     caches, on ctx 1 ... 2048 and on the serving run's short contexts
     with its table width; each row with its split count, a
     bit-identical rerun, its error from both plain versions (the split
     one, P in f32 like the kernel, within 2e-5 for both caches; the
     gather one, P rounded to the cache's type like the JAX package's
     paged_attention_xla, within 2e-5 / 2e-2) and device time a call
     beside the SDPA yardstick's; each row on the vector route), then
     the scalar route at the shape of the d = 256 serving run (S = 4,
     H = 2, d = 256, pages of 16, f32: the path's), with its
     instantiations and layouts at that shape (bf16 pools; q and pools
     in bf16; in f16; f32 pools 4 bytes off a 16-byte boundary), each
     held to both plain versions (the split one within 2e-5, 2e-2 for a
     bf16 or f16 q), the two sub-blocks at decode (f32,
     M = 8, the stream route, with device_ms beside the SIMT kernel's on
     misaligned copies (held to the plain version too) and the library
     chain's, split_ms: the time at every K split beside stream_splits'
     pick, and the stream_max_rows sweep: stream against SIMT at 16, 32,
     64 and 127 rows, the evidence for _STREAM_MAX_ROWS) and at the
     256-row prefill bucket (f32, the FFMA route, with tile_ms: the time
     on every output tile, beside the tile ffma_tiles picks), the
     sub-blocks at the training shape
     (bf16, M = 1024 tokens, the tensor-core route), and the three flash
     kernels at B=1, H=16, T=1024, D=128, causal, in bf16 (the
     tensor-core route) and f32 (SIMT); each sub-block and flash row
     names the route it took (``tc``, ``ffma``, ``stream`` or ``simt``;
     a sub-block
     row on another route than its shape's fails), each flash row the
     share of its elements that
     differ from the plain version (bf16: at most 1%), and the bf16 rows
     (here and in phase 6) give device time per call (tc_times: calls
     queued behind a spin kernel, so the wrapper's host time is not
     counted) beside call_ms, one call timed by events;
  3. the serving path — ``Engine(GPTDecodeModel(GPTConfig.gpt3_1p3b()))``
     serves a request mix (greedy, seeded-sampled, and a shared-prefix
     pair that takes prefill_tail); every request must end "done", every
     kernel of the path must have launched, every decode launch of the
     sub-blocks must take the stream route, every prefill launch below
     128 rows the route stream_route gives it and every prefill launch
     at a bucket of 128 rows or more the FFMA route (launches by route
     and kind of call in sub_block_routes), every paged-attention call
     must take the vector kernel, and one greedy request must decode the
     same tokens when served by the plain versions on the card; then a
     2-layer GPT with heads of 256 (hidden 512, 2 heads), which the
     reference serves and the first paged kernel refused, served through
     Engine: every paged-attention call on the scalar kernel, greedy
     tokens equal to the plain versions' (serving_wide_heads);
  4. train parity — ``HybridParallelTrainStep`` on GPT-3 XL cut to 2
     layers at full width, bf16, 3 steps of 1 x 1024 tokens, through the
     kernels (flash, fused sub-blocks) and through the composed chain,
     same weights and ids: every step's loss must agree within 2e-2
     relative;
  5. the training path — the repo's GPT-3 XL train step (bench.py's
     bench_gpt_1p3b: bf16, flash, remat, dp=pp=tp=1, clip 1.0, batch 1 x
     1024), 1 warm-up + 4 timed steps: finite losses, the last below the
     first, every training kernel launched, and all 48 launches a step
     of each sub-block and of flash_fwd, and all 24 of flash_bwd_dq and
     flash_bwd_dkv, on the tensor-core route; step ms, tokens/s, MFU
     and peak device memory;
  6. BERT: the kernels at the shapes the BERT-base pretrain step gives
     them (phase 2b, run with the other kernel checks): layer norm and
     dropout + residual + layer norm, forward and backward, at R = 2048
     and R = 304 rows of C = 768, f32 and bf16, p = 0 and 0.1, with
     bit-equal dropout masks; all four kernels on the route ln_route
     picks ("warp"), beside the row route (on misaligned copies) and the
     warp route on every grid (grid_ms), reruns bit-identical, row 7 at
     p = 0 writing one gradient (dx_is_dres); the queued
     launch floor; the two sub-blocks at M = 2048 with dropout, post-norm and the
     erf-polynomial gelu (f32 on the FFMA route, with tile_ms, and bf16
     on the tensor cores); the three flash kernels at B=16, H=12, S=128,
     D=64, non-causal, with dropout, with and without a padding mask;
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
     predicts, the 12 launches a step of each flash kernel (bf16) on the
     tensor-core route, of each sub-block (f32, M = 2048) on the FFMA
     route and of each layer-norm kernel (f32, R = 2048 and 304) on the
     warp route; step ms, samples/s, tokens/s, MFU and peak device
     memory;
  9. the encoder-layer phase — one ``TransformerEncoderLayer(768, 12,
     3072)`` with the constructor's defaults (relu, act_dropout =
     dropout = 0.1, post-LN), forward and backward at (16, 128, 768),
     kernels against composed chains; this is the route that launches
     the dropout + residual + layer norm kernels, once each way, both
     on the warp route;
 10. B row 10 (phase 2c, run with the other kernel checks): fused_ffn
     at the bert_base_512 preset (M = 8192, H = 768, I = 3072), at
     M = 2048 and at GPT-3 XL width in bf16, gelu and relu; f32 must
     take the FFMA route and bf16 the tensor cores; the preset in f32
     and bf16 with a misaligned x must take the SIMT kernel; reruns
     bit-identical,
     device time a call beside one call by events, the f32 preset's time
     on every pair of FFMA tiles;
 11. the static LeNet program (bench_lenet, batch 256) and the static FFN
     program at the preset on Executor(CUDAPlace(0)): losses fall, both
     fused_ffn launches a step on the FFMA route, kernel and composed
     losses within 1e-3, peak device memory, one eager run_op;
 12. ResNet (no kernel of the port on this path: convolutions and pools
     are PyTorch's, batch norm the reference's arithmetic in tensor
     code) — resnet_parity: resnet18 at 32 x 32, batch 8, f32, NHWC,
     weights from seed 0, 3 momentum steps on the card and the same 3 on
     the CPU: losses within 1e-3 relative, running statistics within
     1e-4 (+ 1e-4 relative); then under O1 the class-separable batches of
     tests/test_vision_models.py on the card (lr 0.01): the loss falls
     over 6 steps. resnet50_phase: bench.py's bench_resnet50 whole (resnet50,
     1000 classes, NHWC, momentum lr 0.1, O1, batch 256 x 3 x 224 x 224
     resident on the card), 3 warm-up + 10 timed steps: step ms (median),
     images/s, MFU against the bf16 peak, peak memory, the finite loss,
     how far the running statistics moved, the port's launch counts (0),
     and the stem's output NHWC-contiguous on the card;
 13. checkpoints (item 2; checkpoint_phase, right after phase 3, on its
     engine): save the GPT-3 XL weights (f32, 1 MiB content-addressed
     chunks, each fsync'd) under a temporary root, save them again
     unchanged (every chunk a dedup hit, nothing written), build
     Engine.from_checkpoint with phase 3's engine arguments and replay
     phase 3's 8 requests in its order (every token equal, the seeded
     sampled request included), then warm_start(version=7) an engine on
     zero weights while its scheduler thread serves a request, and
     replay again (the same tokens, model_version 7); bytes, chunks,
     save / second-save / restore / warm-start seconds and GB/s, peak
     device memory; the root is removed, and a disk too small fails;
 14. wide&deep (item 21, no kernel of the port on this path: lookups,
     matrix products and the dense Adam are PyTorch's) —
     widedeep_parity: the tiny config, 3 Adam steps on the card against
     the same on the CPU: losses, parameters and both moments within
     1e-4 relative (+ 1e-6); widedeep_phase: bench.py's bench_widedeep
     headline whole (1,048,576-row hashed vocab, 26 slots, embed 16, 13
     dense features, hidden 400-400-400, batch 4096, f32, Adam 1e-3,
     numpy inputs each step), 3 warm-up + 20 timed steps: examples/s,
     median step ms (CUDA events), the same on inputs resident on the
     card, peak memory allocated and requested, the loss finite and
     falling, 0 port launches;
 15. the kernels line, then the card line, then the result line.

Each phase prints its wall seconds ({"phase": "seconds", ...}). One
numpy weight tree (seed 0, 1.3 B parameters) feeds phases 3-5; the
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
# the two routes of the flash kernels (ops/flash_attention.py
# flash_tc_route)
FLASH_DESIGN = {
    "tc": "tensor cores: wgmma bf16 (f32 sums) fed by TMA through 3-D "
          "tensor maps, 2 warpgroups of 64 output rows each (256 threads, "
          "255 registers a thread), thread 0 feeding a 2-4 stage ring; "
          "fwd: K/V tiles of 128, P rounded to bf16 in registers as the A "
          "operand of P V (a pre-pass of Q K^T for the row max where the "
          "reference's key block is wider than the tile); dq: K/V tiles of "
          "64, dS in registers; dkv: S^T = K Q^T over Q tiles of 64, P^T "
          "and dS^T in registers as A of dV and dK; mask, lse and delta "
          "slices ride in the stages by bulk copy",
    "simt": "SIMT f32 FMA on the CUDA cores, 64 x 64 tiles (32 x 32 at D > "
            "128) in f32 shared memory, 256 threads as a 16 x 16 grid; bf16 "
            "rounds P against a pre-pass row max per reference block"}
# the four routes of the sub-block kernels (ops/fused_block.py tc_route,
# ffma_route, stream_route)
DESIGN = {
    "tc": "tensor cores: wgmma m64n128k16 bf16 (f32 sums) on a 6-stage "
          "ring of 128B-swizzled tiles filled by TMA, 1 producer thread + 2 "
          "consumer warpgroups, 128x128 output tiles, no split over K, one "
          "persistent block an SM; fused_ffn_ln passes hid through device "
          "memory in bf16 (two product launches); the LN is a row-kernel "
          "launch",
    "ffma": "f32 FFMA on the CUDA cores (f32 at M >= 128): register-tiled "
            "GEMM of ffma_tile.cuh, 256 threads with 8x8 / 8x4 / 4x4 outputs "
            "each on 128x128 / 128x64 / 64x64 tiles picked per product, a "
            "3-stage cp.async ring of k = 32, no split over K, the epilogue "
            "fused; fused_ffn_ln passes hid through device memory in f32 "
            "(two product launches); the LN is a row-kernel launch",
    "stream": "f32 weight streaming on the CUDA cores (f32, 1 to "
              "_STREAM_MAX_ROWS rows: decode, short prefills; "
              "csrc/stream_gemm.cuh): a block owns 32 columns of W and a K "
              "range (stream_splits: about 2 blocks an SM), a 4-stage ring "
              "of 64-row stages by 16-byte cp.async with A's rows in the "
              "stage, 4/8/16 rows of accumulators a thread, K splits summed "
              "in split order by the last block of a column tile to take "
              "its self-resetting ticket (per-stream workspace), the LN by "
              "the last column tile of a row tile; fused_out_ln one launch, "
              "fused_ffn_ln two with hid in f32 in the workspace",
    "simt": "SIMT f32 register-tiled GEMM on the CUDA cores; split-K "
            "(fused_out_ln) / split-I (fused_ffn_ln) f32 partials summed in "
            "fixed order by the last-arriving block"}
# the three routes of fused_ffn (ops/fused_ffn.py ffn_route)
FFN_DESIGN = {
    "tc": "tensor cores: the sub-blocks' wgmma core (block_gemm.cuh "
          "tc_gemm, 128x128 tiles, one persistent block an SM), two "
          "launches: hid = round(act(x W1 + b1)) in bf16 through device "
          "memory, then y = round(hid W2 + b2) (bias-only epilogue)",
    "ffma": "f32 FFMA on the CUDA cores (f32 at M >= 128): the sub-blocks' "
            "register-tiled core (block_gemm.cuh ffma_gemm), two launches "
            "with hid in f32 through device memory, each product on the "
            "tile ffma_tiles picks",
    "simt": "one launch, hid on chip: a block owns 16 or 32 rows and an H "
            "column tile with its f32 sum in shared memory, walking I in "
            "chunks of 128"}
# the two routes of the layer-norm kernels (ops/layer_norm.py ln_route)
LN_DESIGN = {
    "warp": "a warp owns a row in registers: 16-byte loads (float4 / 8 "
            "bf16) all issued up front, NV vectors a lane (a template "
            "parameter, 32 elements a lane at most: C <= 1024), scale and "
            "bias slices kept for every row the warp takes, two-pass "
            "statistics by xor-butterfly shuffles, no shared memory or "
            "barrier, 16-byte stores; rows a block and blocks from ln_grid",
    "row": "a 64-512-thread block owns a row staged in shared memory as "
           "f32, block sums through shared memory (the first port's "
           "kernel; any C <= 16384, any alignment)"}
# the two routes of the dropout + residual + layer norm kernels, picked
# by the same ln_route over the pointers of a call
DAL_DESIGN = {
    "warp": "a warp owns a row in registers (layer norm's warp frame, "
            "row_norm.cuh): x and res (forward) or z and dy (backward) by "
            "16-byte loads all issued up front, the mask replayed in "
            "registers, two-pass statistics (forward) or both sums in one "
            "pass (backward) by xor-butterfly shuffles, no shared memory "
            "or barrier, 16-byte stores; the forward reads scale and bias "
            "from L1 a row, the backward holds its scale slice; at p = 0 "
            "the backward writes dres alone; rows a block and blocks from "
            "ln_grid",
    "row": "a 64-512-thread block owns a row staged in shared memory as "
           "f32, block sums through shared memory (the first port's "
           "kernels; any C <= 16384, any alignment)"}
# the two routes of paged attention (ops/paged_attention.py paged_route),
# both split over the context: grid (S, H, splits), pages a split from
# paged_splits (table shape and SM count, no host sync), P in f32,
# (m, l, acc) a split merged in split order by the last block of a
# (slot, head) to take its ticket
PAGED_DESIGN = {
    "vector": "K/V rows by 16-byte cp.async through a 4-stage ring of "
              "16-token chunks, 8 lanes a token score 4 tokens a warp (q "
              "f32, pools f32/bf16, d <= 128, aligned and contiguous)",
    "scalar": "plain loads of the pools by their strides, a warp scores "
              "its 4 tokens of a chunk one by one, q and P V in shared "
              "memory (every other call: q and pools f32/bf16/f16, any "
              "d <= 16384, any alignment or strides)"}
# the device functions of ops/csrc, as the profiler names them
PORT_KERNEL_NAMES = ("paged_split_kernel", "paged_scalar_kernel",
                     "out_ln_kernel", "ffn_kernel",
                     "stream_gemm::stream_kernel",
                     "tc_gemm_kernel", "ffma_gemm_kernel", "ln_rows_kernel",
                     "flash_fwd_kernel",
                     "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
                     "tc::flash_fwd_tc_kernel", "tc::flash_bwd_dq_tc_kernel",
                     "tc::flash_bwd_dkv_tc_kernel",
                     "ln_fwd_kernel", "ln_bwd_dx_kernel",
                     "ln_fwd_warp_kernel", "ln_bwd_dx_warp_kernel",
                     "dal_fwd_kernel", "dal_bwd_kernel",
                     "dal_fwd_warp_kernel", "dal_bwd_warp_kernel")
SERVING_KERNELS = ("paged_attention", "fused_out_ln", "fused_ffn_ln")
TRAINING_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                    "fused_out_ln", "fused_ffn_ln")
TRAIN_TOKENS = 1024
# the serving run's page pool: pages and their size
SERVE_PAGES, SERVE_PAGE = 256, 16
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
# (rows 6-7 at 2048 x 768 in f32: the warp route)
ENCODER_LAYER_LAUNCHES = {
    "dropout_add_ln_fwd": 1, "dropout_add_ln_bwd": 1,
    "dropout_add_ln_fwd.warp": 1, "dropout_add_ln_bwd.warp": 1,
    "fused_out_ln": 1, "flash_fwd": 1, "flash_bwd_dq": 1,
    "flash_bwd_dkv": 1}
# the static FFN program: ops/autobench.py's bert_base_512 preset shape
FFN_M, FFN_H, FFN_I = 8192, 768, 3072
FFN_STEPS = 5
# fused_ffn launches of one static FFN step: the forward op, and the
# forward re-run inside fused_ffn_grad (the auto grad differentiates the
# op's compute)
FFN_LAUNCHES_PER_STEP = 2
# bench.py's bench_lenet
LENET_BATCH, LENET_STEPS = 256, 30
# bench.py's bench_resnet50
RESNET_BATCH, RESNET_WARMUP, RESNET_STEPS = 256, 3, 10
# bench.py's bench_widedeep
WD_BATCH, WD_WARMUP, WD_STEPS = 4096, 3, 20
# device work, by name, that changes a tensor's layout, and copies (dtype
# casts among them: torch casts through its direct_copy kernels, whose
# names profile_steps cuts to "...direct_c")
LAYOUT_KERNELS = ("transpose", "Transpose", "nchwToNhwc", "nhwcToNchw")
COPY_KERNELS = ("copy", "Copy", "direct_c")


def timed(name, fn, *args):
    """fn(*args), then one line with the phase's wall seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(json.dumps({"phase": "seconds", "of": name, "seconds": round(
        time.perf_counter() - t0, 2)}), flush=True)
    return out


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


def routed(name, fn, want=None):
    """fn()'s result and the route ("tc", "ffma", "stream", "simt";
    "warp" or "row" for layer norm, "vector" or "scalar" for paged
    attention) that its call of the kernel `name` (a
    sub-block, flash or layer norm) took, read from the per-route
    counters; fails if `want` is given and the route is another."""
    from paddle_tpu_torch.ops import launch_counts
    before = launch_counts()
    out = fn()
    after = launch_counts()
    took = [r for r in design_of(name) if after.get(f"{name}.{r}", 0)
            > before.get(f"{name}.{r}", 0)]
    if len(took) != 1:
        fail(f"{name}: one call took routes {took}")
    if want is not None and took[0] != want:
        fail(f"{name}: took the {took[0]} route, expected {want}")
    return out, took[0]


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
        an event pair around one launch times the host. Here a spin
        kernel holds the stream while the host enqueues every call
        behind it, then the L2 flush, the start event, the calls and the
        end event drain at the device's own pace. A repetition whose
        start event the device reached before the host had queued every
        call (it may have waited on the host) is dropped and the spin
        doubled. Each call works on its own buffers, so after the flush
        every one finds its inputs cold (as far as the sets together
        exceed what L2 would keep)."""
        torch = self.torch
        for fn in fns[:2]:
            fn()
        times, spin = [], 4_000_000
        while len(times) < reps:
            torch.cuda.synchronize()
            torch.cuda._sleep(spin)
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            for fn in fns:
                fn()
            e.record()
            starved = s.query()
            e.synchronize()
            if starved and spin < 1 << 30:
                spin *= 2
                continue
            times.append(s.elapsed_time(e) / len(fns))
        return statistics.median(times)


def check_paged(torch, timer, results):
    """B row 1, the split-context kernel, against its plain version at
    S = 8 slots, H = 16 heads of d = 128, pages of 16 (GPT-3 XL decode),
    f32 and bf16 caches, on two ctx mixes: 1 ... 2048 over a 128-page
    table (one slot of each length class, the longest setting the time),
    and the serving run's short contexts (its prompts half-way through
    their decode) over the serving engine's own table width. Each row
    gives the split count from the table's shape (paged_splits), checks
    a bit-identical rerun, and times the kernel, the plain version and
    SDPA over the gathered, masked context (the gather outside the timed
    call) as device time a call (tc_times), beside one call by events
    (call_ms). Each row is held to two plain versions: the split one
    (paged_attention_split_reference at the kernel's pages a split,
    which keeps P in f32 as the kernel does) within 2e-5 for both
    caches (sums in another order), and the gather one (the port of
    the JAX package's paged_attention_xla) within 2e-5 in f32 and 2e-2
    with a bf16 cache (it rounds the probabilities to bf16)."""
    import torch.nn.functional as F
    from paddle_tpu_torch.models.gpt import GPTConfig
    from paddle_tpu_torch.ops.fused_block import _sms
    from paddle_tpu_torch.ops.paged_attention import (
        paged_attention_decode, paged_attention_reference,
        paged_attention_split_reference, paged_splits)
    S, H, d, ps = 8, 16, 128, SERVE_PAGE
    cfg = GPTConfig.gpt3_1p3b()
    serve_m = min(SERVE_PAGES, cfg.max_position_embeddings // SERVE_PAGE)
    mixes = [("ctx<=2048", 2048 // ps,
              [1, 17, 100, 300, 700, 1200, 1777, 2048]),
             ("ctx=serving mix", serve_m,
              [len(p) + n // 2 for p, n, _ in request_mix(cfg.vocab_size)])]
    g = torch.Generator(device="cuda").manual_seed(0)
    scale = d ** -0.5
    sms = _sms(torch.cuda.current_device())
    for label, M, ctx_list in mixes:
        P = S * M
        ctx = torch.tensor(ctx_list, dtype=torch.int32, device="cuda")
        perm = torch.randperm(P, generator=g, device="cuda")
        pt = perm.reshape(S, M).to(torch.int32).contiguous()
        # the trash page (index P) is a valid page: point the tables'
        # unused tails at it, as the engine does
        for s_, c in enumerate(ctx_list):
            pt[s_, -(-c // ps):] = P
        q = torch.randn(S, H, d, generator=g, device="cuda")
        n_tok = sum(ctx_list)
        pps = paged_splits(S, H, M, sms)
        for name, dt, gather_tol in (("f32", torch.float32, 2e-5),
                                     ("bf16", torch.bfloat16, 2e-2)):
            k = torch.randn(P + 1, ps, H, d, generator=g,
                            device="cuda").to(dt)
            v = torch.randn(P + 1, ps, H, d, generator=g,
                            device="cuda").to(dt)
            args = (q, k, v, pt, ctx, scale)
            got, took = routed("paged_attention",
                               lambda: paged_attention_decode(*args),
                               "vector")
            again = paged_attention_decode(*args)
            ref = paged_attention_split_reference(q, k, v, pt, ctx, pps,
                                                  scale)
            gather = paged_attention_reference(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                fail(f"paged_attention {label} {name}: two runs differ")
            err, gather_err = max_err(got, ref), max_err(got, gather)
            tol = 2e-5
            kd = k[pt.long()].reshape(S, M * ps, H, d).permute(0, 2, 1, 3)
            vd = v[pt.long()].reshape(S, M * ps, H, d).permute(0, 2, 1, 3)
            kd, vd = kd.float().contiguous(), vd.float().contiguous()
            mask = (torch.arange(M * ps, device="cuda")[None, :]
                    < ctx[:, None])[:, None, None, :]
            qd = q[:, :, None, :]
            item = k.element_size()
            nbytes = q.numel() * 4 * 2 + 2 * n_tok * H * d * item \
                + pt.numel() * 4 + S * 4
            bms, by = bound(nbytes, 4 * n_tok * H * d)

            def sdpa(qd, kd, vd, mask, scale):
                return F.scaled_dot_product_attention(
                    qd, kd, vd, attn_mask=mask, scale=scale)

            extra = {"split_ms": split_ms(torch, timer, args, pps)} \
                if label == "ctx<=2048" else {}
            row = {"kernel": "paged_attention",
                   "shape": f"S={S} H={H} d={d} ps={ps} M={M} {label} "
                            f"cache={name}", "route": took,
                   "pages_per_split": pps, "splits": -(-M // pps),
                   "max_abs_err": err, "tol": tol,
                   "gather_err": gather_err, "gather_tol": gather_tol,
                   "bit_identical_rerun": True,
                   **tc_times(torch, timer, args, paged_attention_decode,
                              paged_attention_reference, sdpa,
                              library_args=(qd, kd, vd, mask, scale)),
                   "bound_ms": bms, "bound_by": by, **extra}
            report(results, row, err <= tol)
            if gather_err > gather_tol:
                fail(f"paged_attention ({row['shape']}) max abs err "
                     f"{gather_err} from the gather plain version, outside "
                     f"{gather_tol}")
            del k, v, kd, vd
            torch.cuda.empty_cache()


def check_paged_scalar(torch, timer, results):
    """B row 1's scalar route at the shape of the d = 256 serving run
    (serving_wide_heads_phase: S = 4 slots, H = 2 heads of d = 256, pages
    of 16, its 32-page table, contexts of its first four requests half-way
    through their decode), q and pools in f32 (the path's) and the
    route's other instantiations and layouts at that shape: bf16 pools;
    q and pools in bf16; in f16; f32 pools 4 bytes off a 16-byte
    boundary. Each call must take the scalar route; each row is held to
    the split plain version (P in f32 as the kernel keeps it) within
    2e-5 (2e-2 where q, and so the output, is bf16 or f16) and to the
    gather one on the same terms (2e-2 unless q and pools are f32), with
    a bit-identical rerun, and timed as check_paged's rows (tc_times;
    each timed copy keeps its tensor's alignment)."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.fused_block import _sms
    from paddle_tpu_torch.ops.paged_attention import (
        paged_attention_decode, paged_attention_reference,
        paged_attention_split_reference, paged_splits)
    S, H, d, ps, M = 4, 2, 256, 16, 32
    ctx_list = [72, 28, 37, 110]
    P = S * M
    f32, bf, f16 = torch.float32, torch.bfloat16, torch.float16
    g = torch.Generator(device="cuda").manual_seed(5)
    ctx = torch.tensor(ctx_list, dtype=torch.int32, device="cuda")
    pt = torch.randperm(P, generator=g, device="cuda").reshape(S, M) \
        .to(torch.int32).contiguous()
    for s_, c in enumerate(ctx_list):
        pt[s_, -(-c // ps):] = P
    pps = paged_splits(S, H, M, _sms(torch.cuda.current_device()))
    scale = d ** -0.5
    n_tok = sum(ctx_list)

    def shifted(t, off):
        """A copy of t viewed `off` elements into its storage."""
        buf = torch.empty(t.numel() + off, dtype=t.dtype, device="cuda")
        return buf[off:].view(t.shape).copy_(t)

    def keep_alignment(t):
        return shifted(t, 1) if t.data_ptr() % 16 else t.clone()

    def sdpa(qd, kd, vd, mask, scale):
        return F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask,
                                              scale=scale)

    for label, qdt, kvdt, off in (
            ("q=f32 pools=f32 aligned", f32, f32, 0),
            ("q=f32 pools=bf16 aligned", f32, bf, 0),
            ("q=bf16 pools=bf16 aligned", bf, bf, 0),
            ("q=f16 pools=f16 aligned", f16, f16, 0),
            ("q=f32 pools=f32 4 bytes off", f32, f32, 1)):
        q = torch.randn(S, H, d, generator=g, device="cuda").to(qdt)
        k, v = (shifted(torch.randn(P + 1, ps, H, d, generator=g,
                                    device="cuda").to(kvdt), off)
                for _ in range(2))
        args = (q, k, v, pt, ctx, scale)
        got, took = routed("paged_attention",
                           lambda: paged_attention_decode(*args), "scalar")
        again = paged_attention_decode(*args)
        ref = paged_attention_split_reference(q, k, v, pt, ctx, pps, scale)
        gather = paged_attention_reference(*args)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail(f"paged_attention scalar {label}: two runs differ")
        err, gather_err = max_err(got, ref), max_err(got, gather)
        tol = 2e-5 if qdt == f32 else 2e-2
        gather_tol = 2e-5 if qdt == kvdt == f32 else 2e-2
        kd = k[pt.long()].reshape(S, M * ps, H, d).permute(0, 2, 1, 3)
        vd = v[pt.long()].reshape(S, M * ps, H, d).permute(0, 2, 1, 3)
        kd, vd = kd.float().contiguous(), vd.float().contiguous()
        mask = (torch.arange(M * ps, device="cuda")[None, :]
                < ctx[:, None])[:, None, None, :]
        qd = q[:, :, None, :].float()
        nbytes = 2 * q.numel() * q.element_size() \
            + 2 * n_tok * H * d * k.element_size() + pt.numel() * 4 + S * 4
        bms, by = bound(nbytes, 4 * n_tok * H * d)
        row = {"kernel": "paged_attention",
               "shape": f"S={S} H={H} d={d} ps={ps} M={M} scalar {label}",
               "route": took, "pages_per_split": pps,
               "splits": -(-M // pps), "max_abs_err": err, "tol": tol,
               "gather_err": gather_err, "gather_tol": gather_tol,
               "bit_identical_rerun": True,
               **tc_times(torch, timer, args, paged_attention_decode,
                          paged_attention_reference, sdpa,
                          library_args=(qd, kd, vd, mask, scale),
                          clone=keep_alignment),
               "bound_ms": bms, "bound_by": by}
        report(results, row, err <= tol)
        if gather_err > gather_tol:
            fail(f"paged_attention ({row['shape']}) max abs err "
                 f"{gather_err} from the gather plain version, outside "
                 f"{gather_tol}")


def split_ms(torch, timer, args, rule):
    """Device time a call (Timer.queued, 8 copies of the pools) of the
    paged-attention kernel pair at several pages a split, through the C
    entry point with the split given, beside the pick of
    ops/paged_attention.py paged_splits ("rule"): on `args` (ctx 1 ...
    2048: the longest slot sets the time) and, under "full", with every
    slot's table full (a fresh permutation of the pool, ctx = M * ps):
    the evidence for the rule. Keys: pages a split."""
    import ctypes
    from paddle_tpu_torch.ops import _build
    q, k, v, pt, ctx, scale = args
    S, H, d = q.shape
    ps, M = k.shape[1], pt.shape[1]
    fn = _build.function("paged_attention", "paged_attention_launch", 8, 6,
                         (ctypes.c_float, ctypes.c_int, ctypes.c_void_p))
    stream = torch.cuda.current_stream().cuda_stream
    tickets = torch.zeros(S * H, dtype=torch.int32, device="cuda")
    bf = int(k.dtype == torch.bfloat16)
    pools = [(k.clone(), v.clone()) for _ in range(8)]
    full_pt = torch.randperm(S * M, device="cuda").reshape(S, M) \
        .to(torch.int32).contiguous()
    full_ctx = torch.full_like(ctx, M * ps)

    def run(k, v, table, lens, out, part, pps):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), table.data_ptr(),
                 lens.data_ptr(), out.data_ptr(), part.data_ptr(),
                 tickets.data_ptr(), S, H, d, ps, M, pps, scale, bf, stream)
        if err:
            fail(f"paged_attention at {pps} pages a split: CUDA error {err}")

    times = {"rule": rule, "full": {}}
    for pps in sorted({2, 4, 8, rule, 16, 32, 43, M}):
        part = torch.empty(S * H * -(-M // pps) * (d + 2), device="cuda")
        outs = [torch.empty_like(q) for _ in pools]
        for table, lens, into in ((pt, ctx, times),
                                  (full_pt, full_ctx, times["full"])):
            into[str(pps)] = timer.queued([
                lambda kv=kv, o=o: run(*kv, table, lens, o, part, pps)
                for kv, o in zip(pools, outs)])
    del pools
    torch.cuda.empty_cache()
    return times


def check_blocks(torch, timer, results):
    """The sub-blocks in f32 at GPT-3 XL width, at decode (M = 8, the
    stream route) and at the 256-row prefill bucket (the FFMA route). At
    decode, beside kernel_ms: the stream kernel's device time a call,
    the SIMT kernel's on misaligned copies (and its error from the plain
    version), the library chain's, split_ms and the stream_max_rows
    sweep."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.fused_block import (
        _FFMA_MIN_ROWS, ffn_ln_reference, fused_ffn_ln, fused_out_ln,
        out_ln_reference)
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

    def lib_out(a, w, b, res, ln_s, ln_b):
        zz = torch.addmm(b, a, w).add_(res)
        return F.layer_norm(zz, (D,), ln_s, ln_b, 1e-5)

    def lib_ffn(x, w1, b1, w2, b2, res):
        u = F.gelu(torch.addmm(b1, x, w1), approximate="tanh")
        return torch.addmm(b2, u, w2).add_(res)

    for M in (8, 256):
        want = "ffma" if M >= _FFMA_MIN_ROWS else "stream"
        a = rn(M, D)
        res = rn(M, D)
        args = (a, w, b, res, ln_s, ln_b)
        (z, h), route = routed("fused_out_ln", lambda: fused_out_ln(*args),
                               want)
        zr, hr = out_ln_reference(*args)
        torch.cuda.synchronize()
        err = max(float((z - zr).abs().max()), float((h - hr).abs().max()))
        nbytes = 4 * (M * D + D * D + D + M * D + 2 * D + 2 * M * D)
        bms, by = bound(nbytes, 2 * M * D * D + 10 * M * D)
        row = {"kernel": "fused_out_ln", "shape": f"M={M} D={D} f32",
               "route": route, "max_abs_err": err, "tol": tol,
               "kernel_ms": timer(lambda: fused_out_ln(*args)),
               "plain_ms": timer(lambda: out_ln_reference(*args)),
               "library_ms": timer(lambda: lib_out(*args)), "bound_ms": bms,
               "bound_by": by,
               "device_ms": device_ms(torch, timer, fused_out_ln, args)}
        if route == "ffma":
            row["tile_ms"] = ffma_tile_ms(torch, timer, "fused_out_ln", (
                *args, 0.0, 1e-5, 0))
        else:
            row.update(decode_extras(torch, timer, "fused_out_ln", args,
                                     lib_out, (zr, hr), tol))
        report(results, row, err <= tol)

        x = rn(M, D)
        fargs = (x, w1, b1, w2, b2, res)
        out, route = routed("fused_ffn_ln", lambda: fused_ffn_ln(*fargs),
                            want)
        ref = ffn_ln_reference(*fargs)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        nbytes = 4 * (M * D + D * I + I + I * D + D + M * D + M * D)
        bms, by = bound(nbytes, 4 * M * D * I + 10 * M * I)
        row = {"kernel": "fused_ffn_ln", "shape": f"M={M} H={D} I={I} f32",
               "route": route, "max_abs_err": err, "tol": tol,
               "kernel_ms": timer(lambda: fused_ffn_ln(*fargs)),
               "plain_ms": timer(lambda: ffn_ln_reference(*fargs)),
               "library_ms": timer(lambda: lib_ffn(*fargs)), "bound_ms": bms,
               "bound_by": by,
               "device_ms": device_ms(torch, timer, fused_ffn_ln, fargs)}
        if route == "ffma":
            row["tile_ms"] = ffma_tile_ms(torch, timer, "fused_ffn_ln", (
                *fargs, ln_s, ln_b, "gelu_tanh", "none", 0.0, 1e-5, 0))
        else:
            row.update(decode_extras(torch, timer, "fused_ffn_ln", fargs,
                                     lib_ffn, (ref,), tol))
        report(results, row, err <= tol)
    stream_max_rows_sweep(torch, timer, (w, b, ln_s, ln_b, w1, b1, w2, b2),
                          tol)


def decode_extras(torch, timer, name, args, library, ref, tol):
    """At decode: the SIMT kernel's device time a call on misaligned
    copies of `args` (the route it must take there) and its error from
    the plain version's `ref`, which must be within `tol`; the library
    chain's device time; split_ms."""
    from paddle_tpu_torch.ops.fused_block import fused_ffn_ln, fused_out_ln
    fn = fused_out_ln if name == "fused_out_ln" else fused_ffn_ln
    off = tuple(misaligned(t) for t in args)
    got, _ = routed(name, lambda: fn(*off), "simt")
    got = got if isinstance(got, tuple) else (got,)
    torch.cuda.synchronize()
    err = max(max_err(g_, r_) for g_, r_ in zip(got, ref))
    if err > tol:
        fail(f"{name} SIMT at decode: max abs err {err} outside {tol}")
    return {"simt_device_ms": device_ms(torch, timer, fn, args,
                                        clone=misaligned),
            "simt_max_abs_err": err,
            "library_device_ms": device_ms(torch, timer, library, args),
            "split_ms": stream_split_ms(torch, timer, name, args)}


def stream_launch(torch, name, args, splits):
    """A function that runs the stream route of `name` (fused_out_ln on
    (a, w, b, res, ln_s, ln_b), fused_ffn_ln on (x, w1, b1, w2, b2, res)
    with gelu_tanh, no norm, no dropout) through its C entry point at
    the K splits given (one count, or one a product), at any row count,
    on its own scratch; returns its outputs. Not counted: it is the
    evidence for stream_splits and _STREAM_MAX_ROWS, not the path."""
    import ctypes
    from paddle_tpu_torch.ops import _build
    tail = (ctypes.c_uint, ctypes.c_float, ctypes.c_float, ctypes.c_void_p)
    m = args[0].shape[0]
    n_max = max(t.shape[1] for t in args[:4] if t.dim() == 2)
    # partials, then the LN's (mean, M2) pairs
    part = torch.empty((max(splits) + 1) * m * n_max, device="cuda")
    tickets = torch.zeros(-(-m // 4) * (n_max // 32 + 1), device="cuda",
                          dtype=torch.int32)
    stream = torch.cuda.current_stream().cuda_stream

    def check(err):
        if err:
            fail(f"{name} stream launch at splits {splits}: CUDA error "
                 f"{err}")

    if name == "fused_out_ln":
        a, w, b, res, ls, lb = args
        z, h = torch.empty_like(res), torch.empty_like(res)
        fn = _build.function("fused_block", "fused_out_ln_stream_launch", 10,
                             6, tail)
        ptrs = [t.data_ptr() for t in (a, w, b, res, ls, lb, z, h, part,
                                       tickets)]

        def run():
            check(fn(*ptrs, m, a.shape[1], w.shape[1], splits[0], 0, 0, 0,
                     1.0, 1e-5, stream))
            return z, h
        return run
    x, w1, b1, w2, b2, res = args
    hd, i = w1.shape
    out, hid = torch.empty_like(res), torch.empty((m, i), device="cuda")
    fn = _build.function("fused_block", "fused_ffn_ln_stream_launch", 13, 9,
                         tail)
    ptrs = [t.data_ptr() for t in (x, w1, b1, w2, b2, res)]

    def run():
        check(fn(*ptrs, None, None, out.data_ptr(), None, hid.data_ptr(),
                 part.data_ptr(), tickets.data_ptr(), m, hd, i, *splits, 0,
                 0, 0, 0, 0, 1.0, 1e-5, stream))
        return out
    return run


def stream_split_ms(torch, timer, name, args, n_sets=8):
    """Device time a call (Timer.queued, n_sets copies of the tensors) of
    the stream route at several K splits through its C entry point,
    beside ops/fused_block.py stream_splits' pick ("rule"): fused_out_ln
    at 1 ... 16 splits; fused_ffn_ln at each product's neighbours of its
    pick, the other product at its pick (keys "up/down")."""
    from paddle_tpu_torch.ops.fused_block import _sms, stream_splits
    sms = _sms(torch.cuda.current_device())
    m = args[0].shape[0]
    sets = [tuple(t.clone() for t in args) for _ in range(n_sets)]
    if name == "fused_out_ln":
        k, n = args[1].shape
        rule = stream_splits(m, k, n, sms)
        cands = [(s,) for s in sorted({1, 2, 4, 8, 16, rule})]
        times = {"rule": str(rule)}
    else:
        hd, i = args[1].shape
        r1, r2 = stream_splits(m, hd, i, sms), stream_splits(m, i, hd, sms)
        cands = sorted({(s, r2) for s in (1, 2, 4, r1, 2 * r1)}
                       | {(r1, s) for s in (1, 2, 8, 16, r2, 2 * r2)})
        times = {"rule": f"{r1}/{r2}"}
    for c in cands:
        runs = [stream_launch(torch, name, st, c) for st in sets]
        times["/".join(map(str, c))] = timer.queued(runs)
    del sets
    torch.cuda.empty_cache()
    return times


def stream_max_rows_sweep(torch, timer, weights, tol, n_sets=8):
    """The evidence for _STREAM_MAX_ROWS: at 16, 32, 64 and 127 rows of
    GPT-3 XL width in f32, device time a call (Timer.queued, n_sets
    copies) of the stream route (its C entry point at stream_splits'
    pick, whatever the rule says of the rows) and of the SIMT kernel
    (the wrapper on misaligned copies), each call checked against the
    plain version within `tol`. One line a row count and sub-block."""
    from paddle_tpu_torch.ops.fused_block import (
        _STREAM_MAX_ROWS, _sms, ffn_ln_reference, fused_ffn_ln, fused_out_ln,
        out_ln_reference, stream_splits)
    w, b, ln_s, ln_b, w1, b1, w2, b2 = weights
    D, I = w1.shape
    sms = _sms(torch.cuda.current_device())
    g = torch.Generator(device="cuda").manual_seed(5)
    for M in (16, 32, 64, 127):
        a = torch.randn(M, D, generator=g, device="cuda")
        res = torch.randn(M, D, generator=g, device="cuda")
        for name, args, fn, plain, splits in (
                ("fused_out_ln", (a, w, b, res, ln_s, ln_b), fused_out_ln,
                 out_ln_reference, (stream_splits(M, D, D, sms),)),
                ("fused_ffn_ln", (a, w1, b1, w2, b2, res), fused_ffn_ln,
                 ffn_ln_reference, (stream_splits(M, D, I, sms),
                                    stream_splits(M, I, D, sms)))):
            ref = plain(*args)
            ref = ref if isinstance(ref, tuple) else (ref,)
            got = stream_launch(torch, name, args, splits)()
            got = got if isinstance(got, tuple) else (got,)
            off = tuple(misaligned(t) for t in args)
            simt, _ = routed(name, lambda: fn(*off), "simt")
            simt = simt if isinstance(simt, tuple) else (simt,)
            torch.cuda.synchronize()
            err = max(max_err(x, r) for x, r in zip(got, ref))
            simt_err = max(max_err(x, r) for x, r in zip(simt, ref))
            sets = [tuple(t.clone() for t in args) for _ in range(n_sets)]
            line = {"sweep": "stream_max_rows", "kernel": name, "M": M,
                    "rule_max_rows": _STREAM_MAX_ROWS,
                    "splits": "/".join(map(str, splits)),
                    "stream_ms": timer.queued([
                        stream_launch(torch, name, st, splits)
                        for st in sets]),
                    "simt_ms": device_ms(torch, timer, fn, args,
                                         clone=misaligned),
                    "stream_err": err, "simt_err": simt_err, "tol": tol}
            print(json.dumps(line), flush=True)
            del sets
            torch.cuda.empty_cache()
            if max(err, simt_err) > tol:
                fail(f"{name} at M={M}: stream err {err}, SIMT err "
                     f"{simt_err}, outside {tol}")


def ffma_tile_ms(torch, timer, name, args):
    """The FFMA route's time (one launch between events, CUDA events) of
    the call `name`(*args) on each output tile, and for fused_ffn_ln and
    fused_ffn on each pair of tiles of their two products, through the C
    entry point with the tile given: the evidence for
    ops/fused_block.py ffma_tiles' rule, whose pick is under "rule".
    Keys "128x64" or "128x128/64x64"."""
    import ctypes
    import itertools
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops._launch import _drop_args
    from paddle_tpu_torch.ops.fused_block import (
        _FFMA_TILES, _act_norm, _sms, ffma_tiles)
    tail = (ctypes.c_uint, ctypes.c_float, ctypes.c_float, ctypes.c_void_p)
    stream = torch.cuda.current_stream().cuda_stream
    label = [f"{r}x{c}" for r, c in _FFMA_TILES]
    sms = _sms(torch.cuda.current_device())

    def run(fn, *a):
        err = fn(*a, stream)
        if err:
            fail(f"{name} FFMA launch on a forced tile: CUDA error {err}")

    if name == "fused_ffn":
        x, w1, b1, w2, b2, act = args
        m, hd, i = x.shape[0], x.shape[1], w1.shape[1]
        y, hid = torch.empty_like(x), torch.empty((m, i), device=x.device)
        fn = _build.function("fused_ffn", "fused_ffn_ffma_launch", 7, 6,
                             (ctypes.c_void_p,))
        ptrs = [t.data_ptr() for t in (x, w1, b1, w2, b2, y, hid)]
        code = _act_norm(act, "none")[0]
        times = {f"{label[t1]}/{label[t2]}": timer(lambda t1=t1, t2=t2: run(
            fn, *ptrs, m, hd, i, t1, t2, code))
            for t1, t2 in itertools.product(range(len(label)), repeat=2)}
        times["rule"] = "/".join("x".join(map(str, ffma_tiles(m, c, sms)))
                                 for c in (i, hd))
        return times
    if name == "fused_out_ln":
        a, w, b, res, ls, lb, p, eps, seed = args
        m, k, n = a.shape[0], a.shape[1], w.shape[1]
        z, h = torch.empty_like(res), torch.empty_like(res)
        fn = _build.function("fused_block", "fused_out_ln_ffma_launch", 8, 6,
                             tail)
        ptrs = [t.data_ptr() for t in (a, w, b, res, ls, lb, z, h)]
        times = {label[t]: timer(lambda t=t: run(
            fn, *ptrs, m, k, n, t, *_drop_args(seed, p), eps))
            for t in range(len(label))}
        times["rule"] = "x".join(map(str, ffma_tiles(m, n, sms)))
        return times
    x, w1, b1, w2, b2, res, ls, lb, act, norm, p, eps, seed = args
    m, hd, i = x.shape[0], x.shape[1], w1.shape[1]
    out, hid = torch.empty_like(res), torch.empty((m, i), device=x.device)
    xn, zf = torch.empty_like(x), torch.empty_like(res)
    fn = _build.function("fused_block", "fused_ffn_ln_ffma_launch", 12, 9,
                         tail)
    ptrs = [t.data_ptr() for t in (x, w1, b1, w2, b2, res, ls, lb, out, xn,
                                   hid, zf)]
    codes = _act_norm(act, norm)
    times = {f"{label[t1]}/{label[t2]}": timer(lambda t1=t1, t2=t2: run(
        fn, *ptrs, m, hd, i, t1, t2, *codes, *_drop_args(seed, p), eps))
        for t1, t2 in itertools.product(range(len(label)), repeat=2)}
    times["rule"] = "/".join("x".join(map(str, ffma_tiles(m, c, sms)))
                             for c in (i, hd))
    return times


def device_ms(torch, timer, fn, args, n_sets=8, clone=None):
    """Device time per call of fn(*args) on n_sets copies of the tensors
    (each copied by `clone`, by default Tensor.clone), queued behind
    Timer.queued's spin kernel: the kernels' time without the wrapper's
    host time, which kernel_ms (one call between two events, the device
    idle until the host has launched) includes."""
    clone = clone or (lambda t: t.clone())
    sets = [tuple(clone(t) if torch.is_tensor(t) else t for t in args)
            for _ in range(n_sets)]
    ms = timer.queued([lambda s=s: fn(*s) for s in sets])
    del sets
    torch.cuda.empty_cache()
    return ms


def tc_times(torch, timer, args, kernel, plain, library, n_sets=8,
             library_args=None, clone=None):
    """Times of a kernel row: the kernel, its plain version and the
    library call or chain (on `library_args` where it takes other
    inputs), each called on n_sets copies of its arguments (weights
    included, so every call finds its inputs cold; each tensor copied by
    `clone`, by default Tensor.clone) back to back behind Timer.queued's
    spin kernel: the device time per call. Many kernels run for less
    than their wrapper's host time, which an event pair around one call
    would time instead; that pair is kept as call_ms (host time
    included)."""
    clone = clone or (lambda t: t.clone())

    def copies(a):
        return [tuple(clone(t) if torch.is_tensor(t) else t for t in a)
                for _ in range(n_sets)]

    def each(fn, sets):
        return timer.queued([lambda s=s: fn(*s) for s in sets])

    sets = copies(args)
    times = {"kernel_ms": each(kernel, sets), "plain_ms": each(plain, sets)}
    if library_args is not None:
        del sets
        sets = copies(library_args)
    times["library_ms"] = each(library, sets)
    times["call_ms"] = timer(lambda: kernel(*args))
    del sets
    torch.cuda.empty_cache()
    return times


def check_blocks_bf16(torch, timer, results):
    """The sub-blocks at the training shape: bf16 activations, weights
    and biases with f32 LN vectors, M = 1024 tokens; both take the
    tensor-core route there, and each row says which route it took.
    Tolerance: both the kernel and the plain version accumulate in f32
    from the same bf16 numbers (hid rounded to bf16 on both sides) and
    round each output once to bf16 (2**-8 relative), so |err| <= 2e-2 +
    2e-2 |ref|. Times: tc_times (device time per call)."""
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

    (z, h), route = routed("fused_out_ln", lambda: fused_out_ln(
        a, w, b, res, ln_s, ln_b))
    zr, hr = out_ln_reference(a, w, b, res, ln_s, ln_b)
    torch.cuda.synchronize()
    nbytes = 2 * (M * D + D * D + D + M * D + 2 * M * D) + 4 * 2 * D
    bms, by = bound(nbytes, 2 * M * D * D + 10 * M * D, BF16_FLOPS)
    ls16, lb16 = ln_s.to(bf), ln_b.to(bf)

    def lib_out(a, w, b, res, *_):
        zz = torch.addmm(b, a, w).add_(res)
        return F.layer_norm(zz, (D,), ls16, lb16, 1e-5)

    row = {"kernel": "fused_out_ln", "shape": f"M={M} D={D} bf16",
           "route": route,
           "max_abs_err": max(max_err(z, zr), max_err(h, hr)), "tol": tol,
           **tc_times(torch, timer, (a, w, b, res, ln_s, ln_b),
                      fused_out_ln, out_ln_reference, lib_out),
           "bound_ms": bms, "bound_by": by}
    report(results, row, within(z, zr, **tol) and within(h, hr, **tol))

    out, route = routed("fused_ffn_ln", lambda: fused_ffn_ln(
        x, w1, b1, w2, b2, res))
    ref = ffn_ln_reference(x, w1, b1, w2, b2, res)
    torch.cuda.synchronize()
    nbytes = 2 * (M * D + D * I + I + I * D + D + M * D + M * D)
    bms, by = bound(nbytes, 4 * M * D * I + 10 * M * I, BF16_FLOPS)

    def lib_ffn(x, w1, b1, w2, b2, res):
        u = F.gelu(torch.addmm(b1, x, w1), approximate="tanh")
        return torch.addmm(b2, u, w2).add_(res)

    row = {"kernel": "fused_ffn_ln", "shape": f"M={M} H={D} I={I} bf16",
           "route": route, "max_abs_err": max_err(out, ref), "tol": tol,
           **tc_times(torch, timer, (x, w1, b1, w2, b2, res), fused_ffn_ln,
                      ffn_ln_reference, lib_ffn),
           "bound_ms": bms, "bound_by": by}
    report(results, row, within(out, ref, **tol))


def misaligned(t):
    """A contiguous copy of t 8 bytes past a 16-byte boundary, which
    the tensor-core, FFMA and stream routes do not take."""
    item = t.element_size()
    flat = t.new_empty(t.numel() + 8 // item)
    y = flat[8 // item:].view(t.shape)
    y.copy_(t)
    if y.data_ptr() % 16 != 8:
        fail(f"misaligned: a copy at {y.data_ptr() % 16} bytes off 16")
    return y


def differ(got, ref) -> float:
    """The share of elements that are not the same number."""
    return float((got != ref).float().mean())


def flash_rows(torch, timer, results, q, k, v, do, tail, shape, peak,
               n_el, mbytes, lib_fwd, lib_bwd, extra=None):
    """The three flash kernels on one input set (BH, S|T, D), each
    against its plain version: a row names the route the call took, the
    max abs error, the share of elements that differ from the plain
    version, the times and the bound. Tolerances: f32, |err| <= 1e-4 +
    1e-4 |ref| (sums of up to T terms in another order); bf16, 2e-2 +
    2e-2 |ref| with at most 1% of the elements differing, on the
    tensor-core route (both sides round P, the dropped P and dS to bf16
    where the reference does and sum in f32, in another order); lse is
    f32 in both, 1e-4. Times: bf16
    rows tc_times (device time per call) with one call's event time
    beside it; f32 rows events a call. lib_fwd(q, k, v) and lib_bwd(q,
    k, v, do) are the library yardsticks (SDPA forward; forward +
    backward, the same for both backward rows)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    bh, t, d = k.shape
    item = q.element_size()
    bf16 = q.dtype == torch.bfloat16
    tol = {"atol": 2e-2, "rtol": 2e-2} if bf16 else {"atol": 1e-4,
                                                      "rtol": 1e-4}

    def times(args, kernel, plain, library):
        if bf16:
            return tc_times(torch, timer, args, kernel, plain, library)
        return {"kernel_ms": timer(lambda: kernel(*args)),
                "plain_ms": timer(lambda: plain(*args)),
                "library_ms": timer(lambda: library(*args))}

    def check(name, route, pairs, nbytes, flops, args, kernel, plain,
              library, ok=True):
        bms, by = bound(nbytes, flops, peak)
        share = max(differ(g, r) for g, r in pairs)
        row = {"kernel": name, "shape": shape, "route": route,
               "max_abs_err": max(max_err(g, r) for g, r in pairs),
               "differ": share, "tol": tol,
               **times(args, kernel, plain, library), "bound_ms": bms,
               "bound_by": by, **(extra or {})}
        # every bf16 row here has D = 64 or 128: the tensor-core route
        report(results, row, ok and all(within(g, r, **tol)
                                         for g, r in pairs)
               and (not bf16 or (share <= 0.01 and route == "tc")))

    (o, lse), route = routed("flash_fwd",
                             lambda: fa._fwd_kernel(q, k, v, *tail))
    o_r, lse_r = fa.flash_fwd_reference(q, k, v, *tail)
    torch.cuda.synchronize()
    check("flash_fwd", route, [(o, o_r)],
          item * 4 * bh * t * d + 4 * bh * t + mbytes, 4 * d * n_el,
          (q, k, v), lambda *a: fa._fwd_kernel(*a, *tail),
          lambda *a: fa.flash_fwd_reference(*a, *tail), lib_fwd,
          within(lse, lse_r, 1e-4, 1e-4))

    delta = fa.bwd_delta(o, do)
    args = (q, k, v, do, lse, delta)
    plain_args = (q, k, v, o, lse, do)
    dq, route = routed("flash_bwd_dq", lambda: fa._dq_kernel(*args, *tail))
    dq_r = fa.bwd_dq_reference(*plain_args, *tail)
    torch.cuda.synchronize()
    check("flash_bwd_dq", route, [(dq, dq_r)],
          item * 5 * bh * t * d + 8 * bh * t + mbytes, 6 * d * n_el,
          args, lambda *a: fa._dq_kernel(*a, *tail),
          lambda q, k, v, do, lse, _: fa.bwd_dq_reference(
              q, k, v, o, lse, do, *tail),
          lambda q, k, v, do, *_: lib_bwd(q, k, v, do))

    (dk, dv), route = routed("flash_bwd_dkv",
                             lambda: fa._dkv_kernel(*args, *tail))
    dk_r, dv_r = fa.bwd_dkv_reference(*plain_args, *tail)
    torch.cuda.synchronize()
    check("flash_bwd_dkv", route, [(dk, dk_r), (dv, dv_r)],
          item * 6 * bh * t * d + 8 * bh * t + mbytes, 8 * d * n_el,
          args, lambda *a: fa._dkv_kernel(*a, *tail),
          lambda q, k, v, do, lse, _: fa.bwd_dkv_reference(
              q, k, v, o, lse, do, *tail),
          lambda q, k, v, do, *_: lib_bwd(q, k, v, do))


def sdpa_yardsticks(torch, b, h, **kw):
    """lib_fwd, lib_bwd for flash_rows: one SDPA call on (B, H, T, D)
    views of the same inputs (forward; forward + backward)."""
    import torch.nn.functional as F

    def four(x):
        return x.reshape(b, h, *x.shape[1:])

    def lib_fwd(q, k, v):
        return F.scaled_dot_product_attention(four(q), four(k), four(v),
                                              **kw)

    def lib_bwd(q, k, v, do):
        ql, kl, vl = (four(x).detach().requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(ql, kl, vl, **kw)
        return torch.autograd.grad(out, (ql, kl, vl), four(do))

    return lib_fwd, lib_bwd


def check_flash(torch, timer, results):
    """The three flash kernels at the training shape (B=1, H=16, T=1024,
    D=128, causal) in bf16 (the training path's type: the tensor-core
    route) and f32 (the SIMT route); flash_rows has the tolerances."""
    B, H, T, D = 1, 16, TRAIN_TOKENS, 128
    BH = B * H
    scale = D ** -0.5
    g = torch.Generator(device="cuda").manual_seed(3)
    # score elements the causal kernels need: T (T + 1) / 2 per head
    n_el = BH * T * (T + 1) // 2
    lib_fwd, lib_bwd = sdpa_yardsticks(torch, B, H, is_causal=True)
    for name, dt, peak in (("bf16", torch.bfloat16, BF16_FLOPS),
                           ("f32", torch.float32, F32_FLOPS)):
        q, k, v, do = (torch.randn(BH, T, D, generator=g, device="cuda")
                       .to(dt) for _ in range(4))
        flash_rows(torch, timer, results, q, k, v, do,
                   (scale, True, None, 0, 0.0),
                   f"B={B} H={H} T={T} D={D} causal {name}", peak, n_el, 0,
                   lib_fwd, lib_bwd)


def ln_grid_ms(torch, timer, name, args, n_sets=16):
    """Device time a call (Timer.queued, n_sets copies of the tensors) of
    the row kernel `name`'s warp route through its C entry point at
    several grids (rows a block x blocks), beside ops/layer_norm.py
    ln_grid's pick ("rule"): a row a warp at 1, 2, 4 and 8 rows a block,
    and 8 or 4 rows a block on one or two blocks an SM, each warp then
    walking rows. args: (x, scale, bias, eps) for layer_norm_fwd, (x,
    scale, mean, rstd, dy) for layer_norm_bwd_dx, (x, res, scale, bias,
    seed, p, eps) for dropout_add_ln_fwd, (z, scale, mean, rstd, dy,
    seed, p) for dropout_add_ln_bwd (no dx at p = 0, as the wrapper)."""
    import ctypes
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops._launch import _drop_args, _dtype_code, _sms
    from paddle_tpu_torch.ops.layer_norm import ln_grid
    x = args[0]
    R, C = x.shape
    code = _dtype_code(x, name)
    sms = _sms(torch.cuda.current_device())
    rule = ln_grid(R, sms)
    stream = torch.cuda.current_stream().cuda_stream

    def stats():
        mean = torch.empty(R, device="cuda")
        return mean, torch.empty_like(mean)

    if name == "layer_norm_fwd":
        lib, n_ptr, floats = "layer_norm", 6, (ctypes.c_float,)
        sets = [(xi, args[1], args[2], torch.empty_like(xi), *stats())
                for xi in (x.clone() for _ in range(n_sets))]
        tail = [R, C, code, float(args[3])]
    elif name == "layer_norm_bwd_dx":
        lib, n_ptr, floats = "layer_norm", 6, ()
        sets = [(x.clone(), args[1], args[2], args[3], args[4].clone(),
                 torch.empty_like(x)) for _ in range(n_sets)]
        tail = [R, C, code]
    elif name == "dropout_add_ln_fwd":
        lib, n_ptr = "fused_residual", 8
        floats = (ctypes.c_uint, ctypes.c_float, ctypes.c_float)
        sets = [(x.clone(), args[1].clone(), args[2], args[3],
                 torch.empty_like(x), torch.empty_like(x), *stats())
                for _ in range(n_sets)]
        tail = [R, C, code, *_drop_args(args[4], args[5]), float(args[6])]
    else:
        lib, n_ptr = "fused_residual", 7
        floats = (ctypes.c_uint, ctypes.c_float)
        seed, on, thr, keep_div = _drop_args(args[5], args[6])
        sets = [(x.clone(), args[1], args[2], args[3], args[4].clone(),
                 torch.empty_like(x) if on else None, torch.empty_like(x))
                for _ in range(n_sets)]
        tail = [R, C, code, seed, on, thr, keep_div]
    fn = _build.function(lib, f"{name}_warp_launch", n_ptr,
                         len(tail) - len(floats),
                         floats + (ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p))

    def run(st, grid):
        err = fn(*(None if t is None else t.data_ptr() for t in st), *tail,
                 *grid, stream)
        if err:
            fail(f"{name} warp route at grid {grid}: CUDA error {err}")

    cands = sorted({(w, math.ceil(R / w)) for w in (1, 2, 4, 8)}
                   | {(8, sms), (8, 2 * sms), (4, sms), (4, 2 * sms), rule})
    times = {"rule": f"{rule[0]}x{rule[1]}"}
    for grid in cands:
        times[f"{grid[0]}x{grid[1]}"] = timer.queued(
            [lambda st=st, grid=grid: run(st, grid) for st in sets])
    del sets
    return times


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
    time. Every row (layer norm and dal_rows' rows 6-7, p = 0 and 0.1)
    takes the route ln_route picks (read from the route counters, "warp"
    at these shapes) and carries the row route's time and error beside
    it (row_ms, row_max_abs_err: the first port's block-a-row kernel,
    which ln_route gives misaligned copies of the same inputs), a rerun
    checked bit-equal and the warp route at every grid (grid_ms). Row
    7's library time is the autograd backward of
    F.layer_norm(res + F.dropout(x, p)), its graph kept between calls."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import layer_norm as ln
    C, eps = 768, 1e-12
    # the least a launch costs when queued this way: PyTorch's fill kernel
    # on one element, against which the rows' few microseconds are read
    ones = [torch.empty(1, device="cuda") for _ in range(16)]
    print(json.dumps({"phase": "launch_floor", "what": "Tensor.fill_ of "
                      "one float32 element, Timer.queued over 16 calls",
                      "ms": timer.queued([lambda t=t: t.fill_(1.0)
                                          for t in ones])}), flush=True)
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
            # the row route's inputs: misaligned copies
            xm, dym = misaligned(x), misaligned(dy)
            xms, dyms = ([misaligned(t) for t in ts] for ts in (xs, dys))

            def each(fn):
                return timer.queued([lambda i=i: fn(i) for i in sets])

            (y, mean, rstd), route = routed(
                "layer_norm_fwd", lambda: ln._fwd_kernel(x, s, b, eps),
                "warp")
            (y_w, mean_w, rstd_w), _ = routed(
                "layer_norm_fwd", lambda: ln._fwd_kernel(xm, s, b, eps),
                "row")
            y_r, mean_r, rstd_r = ln.layer_norm_reference(x, s, b, eps)
            again = ln._fwd_kernel(x, s, b, eps)
            torch.cuda.synchronize()
            same = all(torch.equal(a, w) for a, w in zip((y, mean, rstd),
                                                         again))
            bms, by = bound(2 * R * C * item + 8 * C + 8 * R, 8 * R * C)
            row = {"kernel": "layer_norm_fwd", "shape": shape,
                   "route": route, "rerun_bit_equal": same,
                   "max_abs_err": max_err(y, y_r),
                   "row_max_abs_err": max_err(y_w, y_r), "tol": tol,
                   "kernel_ms": each(lambda i: ln._fwd_kernel(xs[i], s, b,
                                                              eps)),
                   "row_ms": each(lambda i: ln._fwd_kernel(
                       xms[i], s, b, eps)),
                   "plain_ms": each(lambda i: ln.layer_norm_reference(
                       xs[i], s, b, eps)),
                   "library_ms": each(lambda i: F.layer_norm(
                       xs[i], (C,), sl, bl, eps)),
                   "grid_ms": ln_grid_ms(torch, timer, "layer_norm_fwd",
                                         (x, s, b, eps)),
                   "bound_ms": bms, "bound_by": by}
            report(results, row, same and all(
                within(a, y_r, **tol) and within(m, mean_r, 1e-4, 1e-4)
                and within(r_, rstd_r, 1e-4, 1e-4)
                for a, m, r_ in ((y, mean, rstd), (y_w, mean_w, rstd_w))))

            dx, route = routed("layer_norm_bwd_dx", lambda: ln._bwd_dx_kernel(
                x, s, mean, rstd, dy), "warp")
            dx_w, _ = routed("layer_norm_bwd_dx", lambda: ln._bwd_dx_kernel(
                xm, s, mean, rstd, dym), "row")
            dx_r = ln.layer_norm_bwd_dx_reference(x, s, mean, rstd, dy)
            same = torch.equal(dx, ln._bwd_dx_kernel(x, s, mean, rstd, dy))
            bms, by = bound(3 * R * C * item + 4 * C + 8 * R, 11 * R * C)
            # the library's backward takes its own forward's statistics
            _, m2, r2 = torch.native_layer_norm(x, [C], sl, bl, eps)
            row = {"kernel": "layer_norm_bwd_dx", "shape": shape,
                   "route": route, "rerun_bit_equal": same,
                   "max_abs_err": max_err(dx, dx_r),
                   "row_max_abs_err": max_err(dx_w, dx_r), "tol": tol,
                   "kernel_ms": each(lambda i: ln._bwd_dx_kernel(
                       xs[i], s, mean, rstd, dys[i])),
                   "row_ms": each(lambda i: ln._bwd_dx_kernel(
                       xms[i], s, mean, rstd, dyms[i])),
                   "plain_ms": each(
                       lambda i: ln.layer_norm_bwd_dx_reference(
                           xs[i], s, mean, rstd, dys[i])),
                   "library_ms": each(
                       lambda i: torch.ops.aten.native_layer_norm_backward(
                           dys[i], xs[i], [C], m2, r2, sl, bl,
                           [True, False, False])),
                   "grid_ms": ln_grid_ms(torch, timer, "layer_norm_bwd_dx",
                                         (x, s, mean, rstd, dy)),
                   "bound_ms": bms, "bound_by": by}
            report(results, row, same and within(dx, dx_r, **tol)
                   and within(dx_w, dx_r, **tol))

            for p in (0.0, 0.1):
                dal_rows(torch, timer, results, each, shape, p,
                         (x, res, dy, s, b, sl, bl, xs, rs, dys), tol)


def dal_rows(torch, timer, results, each, shape, p, data, tol):
    """Rows 6-7 at one shape and p, as check_rows' layer-norm rows: the
    route ln_route picks ("warp" here; read from the counters), the row
    route on misaligned copies (row_ms, row_max_abs_err), a rerun
    bit-equal, every grid of the warp route (grid_ms), the masks of both
    routes bit-equal. Row 7 at p = 0 writes dres alone and returns it as
    dx too (dx_is_dres): its bound counts the three tensors it moves."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import fused_residual as fr
    x, res, dy, s, b, sl, bl, xs, rs, dys = data
    R, C = x.shape
    eps, seed = 1e-12, 20240917
    item = x.element_size()
    sets = range(len(xs))
    pshape = f"{shape} p={p}"
    xm, resm, dym = (misaligned(t) for t in (x, res, dy))
    xms, rms, dyms = ([misaligned(t) for t in ts] for ts in (xs, rs, dys))

    def fwd(a, r_):
        return fr._fwd_kernel(a, r_, s, b, seed, p, eps)

    (y, z, mean, rstd), route = routed("dropout_add_ln_fwd",
                                       lambda: fwd(x, res), "warp")
    (y_w, z_w, mean_w, rstd_w), _ = routed("dropout_add_ln_fwd",
                                           lambda: fwd(xm, resm), "row")
    again = fwd(x, res)
    y_r, z_r, mean_r, rstd_r = fr.dropout_add_ln_reference(
        x, res, s, b, seed, p, eps)
    torch.cuda.synchronize()
    same = all(torch.equal(a, w) for a, w in zip((y, z, mean, rstd), again))
    bms, by = bound(4 * R * C * item + 8 * C + 8 * R, 10 * R * C)
    row = {"kernel": "dropout_add_ln_fwd", "shape": pshape, "route": route,
           "rerun_bit_equal": same,
           "max_abs_err": max(max_err(y, y_r), max_err(z, z_r)),
           "row_max_abs_err": max(max_err(y_w, y_r), max_err(z_w, z_r)),
           "tol": tol,
           "kernel_ms": each(lambda i: fwd(xs[i], rs[i])),
           "row_ms": each(lambda i: fwd(xms[i], rms[i])),
           "plain_ms": each(lambda i: fr.dropout_add_ln_reference(
               xs[i], rs[i], s, b, seed, p, eps)),
           "library_ms": each(lambda i: F.layer_norm(
               rs[i] + F.dropout(xs[i], p), (C,), sl, bl, eps)),
           "grid_ms": ln_grid_ms(torch, timer, "dropout_add_ln_fwd",
                                 (x, res, s, b, seed, p, eps)),
           "bound_ms": bms, "bound_by": by}
    report(results, row, same and all(
        within(a, y_r, **tol) and within(z_, z_r, **tol)
        and within(m, mean_r, 1e-4, 1e-4) and within(r_, rstd_r, 1e-4, 1e-4)
        for a, z_, m, r_ in ((y, z, mean, rstd),
                             (y_w, z_w, mean_w, rstd_w))))

    zs = [z.clone() for _ in sets]
    zm, zms = misaligned(z), [misaligned(t) for t in zs]
    # the library's backward: autograd through its own forward on each
    # set, the graph kept for every timed call
    xg = [t.clone().requires_grad_() for t in xs]
    rg = [t.clone().requires_grad_() for t in rs]
    outs = [F.layer_norm(rg[i] + F.dropout(xg[i], p), (C,), sl, bl, eps)
            for i in sets]

    def bwd(z_, dy_):
        return fr._bwd_kernel(z_, s, mean, rstd, dy_, seed, p)

    (dx, dres), route = routed("dropout_add_ln_bwd", lambda: bwd(z, dy),
                               "warp")
    (dx_w, dres_w), _ = routed("dropout_add_ln_bwd", lambda: bwd(zm, dym),
                               "row")
    again = bwd(z, dy)
    dx_r, dres_r = fr.dropout_add_ln_bwd_reference(z, s, mean, rstd, dy,
                                                   seed, p)
    torch.cuda.synchronize()
    same = torch.equal(dx, again[0]) and torch.equal(dres, again[1])
    one = dx is dres and dx_w is dres_w
    masks_equal = True
    if p > 0:
        keep = fr.keep_mask(seed, R, C, p, "cuda")
        masks_equal = all(bool(torch.equal(a != 0, keep & (w != 0)))
                          for a, w in ((dx, dres), (dx_w, dres_w)))
    # p = 0: z, dy and dres; p > 0: dx too
    bms, by = bound((3 if p == 0 else 4) * R * C * item + 4 * C + 8 * R,
                    13 * R * C)
    row = {"kernel": "dropout_add_ln_bwd", "shape": pshape, "route": route,
           "rerun_bit_equal": same, "dx_is_dres": one,
           "max_abs_err": max(max_err(dx, dx_r), max_err(dres, dres_r)),
           "row_max_abs_err": max(max_err(dx_w, dx_r),
                                  max_err(dres_w, dres_r)),
           "tol": tol, "masks_bit_equal": masks_equal,
           "kernel_ms": each(lambda i: bwd(zs[i], dys[i])),
           "row_ms": each(lambda i: bwd(zms[i], dyms[i])),
           "plain_ms": each(lambda i: fr.dropout_add_ln_bwd_reference(
               zs[i], s, mean, rstd, dys[i], seed, p)),
           "library_ms": each(lambda i: torch.autograd.grad(
               outs[i], (xg[i], rg[i]), dys[i], retain_graph=True)),
           "grid_ms": ln_grid_ms(torch, timer, "dropout_add_ln_bwd",
                                 (z, s, mean, rstd, dy, seed, p)),
           "bound_ms": bms, "bound_by": by}
    report(results, row, same and masks_equal and one == (p == 0) and all(
        within(a, dx_r, **tol) and within(w, dres_r, **tol)
        for a, w in ((dx, dres), (dx_w, dres_w))))


def check_blocks_bert(torch, timer, results):
    """The sub-blocks as the BERT-base step launches them: M = 2048
    tokens, D = H = 768, I = 3072, dropout 0.1, eps 1e-12; fused_ffn_ln
    with the erf-polynomial gelu and post-norm. f32 is the path's type
    (AMP O1 leaves both block ops off its lists, so they see f32 weights
    and residuals); bf16 beside it. Tolerances as in check_blocks /
    check_blocks_bf16, the f32 one widened to 2e-4 for the division by
    1 - p and the I = 3072 sums. A zero residual exposes the mask: z is
    zero exactly where keep_mask dropped. The f32 rows must take the
    FFMA route, the bf16 rows the tensor cores."""
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

        want = "ffma" if dt == torch.float32 else "tc"
        args = (a, w, b, res, ln_s, ln_b, p, eps, seed)
        (z, h), route = routed("fused_out_ln", lambda: fused_out_ln(*args),
                               want)
        zr, hr = out_ln_reference(*args)
        z0, _ = fused_out_ln(a, w, b, torch.zeros_like(res), ln_s, ln_b, p,
                             eps, seed)
        torch.cuda.synchronize()
        masks_equal = bool(torch.equal(z0 != 0,
                                       keep_mask(seed, M, D, p, "cuda")))
        bms, by = bound(item * (M * D + D * D + D + M * D + 2 * M * D)
                        + 8 * D, 2 * M * D * D + 12 * M * D, peak)

        def lib_out(a, w, b, res, *_):
            zz = F.dropout(torch.addmm(b, a, w), p).add_(res)
            return F.layer_norm(zz, (D,), ls, lb, eps)

        times = tc_times(torch, timer, args, fused_out_ln, out_ln_reference,
                         lib_out) if dt == torch.bfloat16 else {
            "kernel_ms": timer(lambda: fused_out_ln(*args)),
            "plain_ms": timer(lambda: out_ln_reference(*args)),
            "library_ms": timer(lambda: lib_out(*args)),
            "device_ms": device_ms(torch, timer, fused_out_ln, args),
            "tile_ms": ffma_tile_ms(torch, timer, "fused_out_ln", args)}
        row = {"kernel": "fused_out_ln",
               "shape": f"M={M} D={D} {name} p={p} (BERT)", "route": route,
               "max_abs_err": max(max_err(z, zr), max_err(h, hr)),
               "tol": tol, "masks_bit_equal": masks_equal, **times,
               "bound_ms": bms, "bound_by": by}
        report(results, row, masks_equal and within(z, zr, **tol)
               and within(h, hr, **tol))

        fargs = (x, w1, b1, w2, b2, res, ln_s, ln_b, "gelu", "post", p, eps,
                 seed)
        out, route = routed("fused_ffn_ln", lambda: fused_ffn_ln(*fargs),
                            want)
        ref = ffn_ln_reference(*fargs)
        torch.cuda.synchronize()
        bms, by = bound(item * (M * D + D * I + I + I * D + D + 2 * M * D)
                        + 8 * D, 4 * M * D * I + 25 * M * I + 12 * M * D,
                        peak)

        def lib_ffn(x, w1, b1, w2, b2, res, *_):
            u = F.gelu(torch.addmm(b1, x, w1))
            zz = F.dropout(torch.addmm(b2, u, w2), p).add_(res)
            return F.layer_norm(zz, (D,), ls, lb, eps)

        times = tc_times(torch, timer, fargs, fused_ffn_ln, ffn_ln_reference,
                         lib_ffn) if dt == torch.bfloat16 else {
            "kernel_ms": timer(lambda: fused_ffn_ln(*fargs)),
            "plain_ms": timer(lambda: ffn_ln_reference(*fargs)),
            "library_ms": timer(lambda: lib_ffn(*fargs)),
            "device_ms": device_ms(torch, timer, fused_ffn_ln, fargs),
            "tile_ms": ffma_tile_ms(torch, timer, "fused_ffn_ln", fargs)}
        row = {"kernel": "fused_ffn_ln",
               "shape": f"M={M} H={D} I={I} {name} gelu post p={p} (BERT)",
               "route": route, "max_abs_err": max_err(out, ref), "tol": tol,
               **times, "bound_ms": bms, "bound_by": by}
        report(results, row, within(out, ref, **tol))


def check_flash_bert(torch, timer, results):
    """The three flash kernels as the BERT-base step launches them:
    B=16, H=12, S=T=128, D=64, non-causal, dropout 0.1, in bf16 (the
    path's type: fused_attention is on the O1 white list; the
    tensor-core route) and f32 (SIMT), with and without a padding mask
    (B, 1, 1, T) whose rows pad 0..45 trailing keys; flash_rows has the
    tolerances. Two identity-block V's expose the dropout mask bit for
    bit (masks_bit_equal)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    B, H, T, D, p, seed = BERT_BATCH, 12, BERT_SEQ, 64, 0.1, 4242
    BH = B * H
    scale = D ** -0.5
    g = torch.Generator(device="cuda").manual_seed(6)
    pad = torch.zeros(B, T, device="cuda")
    for i in range(B):
        pad[i, T - 3 * i:] = -1e9 if i else 0.0
    n_el = BH * T * T
    for name, dt, peak in (("bf16", torch.bfloat16, BF16_FLOPS),
                           ("f32", torch.float32, F32_FLOPS)):
        q, k, v, do = (torch.randn(BH, T, D, generator=g, device="cuda")
                       .to(dt) for _ in range(4))

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
            mask4 = None if mask2 is None else mask2[:, None, None, :].to(dt)
            lib_fwd, lib_bwd = sdpa_yardsticks(torch, B, H, attn_mask=mask4,
                                               dropout_p=p)
            flash_rows(
                torch, timer, results, q, k, v, do,
                (scale, False, mask2, seed, p),
                f"B={B} H={H} S=T={T} D={D} {name} p={p} {mname} (BERT)",
                peak, n_el, 0 if mask2 is None else 4 * B * T, lib_fwd,
                lib_bwd, {"masks_bit_equal": masks_equal})
        if not masks_equal:
            fail(f"flash dropout masks differ from keep_mask_salted ({name})")


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


def serve_mix(eng, mix):
    """Phase 3's order: request 0, one step (its prefill, so its pages
    are cached for request 7), then the other seven; run to idle on the
    calling thread. Returns the requests."""
    first = eng.submit(mix[0][0], mix[0][1], **mix[0][2])
    eng.step()
    reqs = [first] + [eng.submit(p, n, **kw) for p, n, kw in mix[1:]]
    eng.run_until_idle()
    return reqs


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
    eng = Engine(model, num_slots=8, num_pages=SERVE_PAGES,
                 page_size=SERVE_PAGE,
                 prefix_cache_pages=64)
    mix = request_mix(cfg.vocab_size)
    by_call = tap_sub_block_routes(model)

    reset_launch_counts()
    t0 = time.perf_counter()
    reqs = serve_mix(eng, mix)
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
    # GPT-3 XL's heads (d = 128, pages of 16, f32 pools): every paged
    # attention call on the vector kernel
    if counts.get("paged_attention.scalar", 0) \
            or counts.get("paged_attention.vector", 0) \
            != counts["paged_attention"]:
        fail(f"serving path: paged attention off the vector kernel: "
             f"{counts}")
    for name in ("prefill", "prefill_tail", "decode"):   # the class's again
        delattr(model, name)
    check_serving_routes(by_call)
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
            "compiles": st["compiles"], "launches": counts,
            "sub_block_routes": by_call}
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
    return counts, eng, [r.result().tolist() for r in reqs]


def checkpoint_phase(torch, eng, want):
    """Item 2 on phase 3's GPT-3 XL engine: save eng.model under a fresh
    temporary root, save it again unchanged (every chunk of the second
    save a dedup hit: nothing written), build
    Engine.from_checkpoint with phase 3's engine arguments and replay
    request_mix in phase 3's order (all 8 requests, the seeded sampled
    request 5 included, must give phase 3's tokens `want`); then a third
    engine on zero weights of the same shapes, made on the card, its
    scheduler thread running, warm-started with version 7 while a
    request is in flight, replays the mix to the same tokens and
    reports model_version 7. The root is removed at the end, success or
    failure; a disk too small for one copy of the weights fails."""
    import shutil
    import tempfile
    import numpy as np
    from paddle_tpu_torch.checkpoint import CheckpointStore
    from paddle_tpu_torch.observability import REGISTRY
    from paddle_tpu_torch.serving import Engine, GPTDecodeModel
    kw = dict(num_slots=8, num_pages=SERVE_PAGES, page_size=SERVE_PAGE,
              prefix_cache_pages=64)
    cfg = eng.model.cfg
    mix = request_mix(cfg.vocab_size)
    params = eng.model.params
    leaves = [params[k] for k in params if k != "blocks"] \
        + [t for blk in params["blocks"] for t in blk.values()]
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    written = REGISTRY.get("paddle_tpu_ckpt_chunks_written_total")
    dedup = REGISTRY.get("paddle_tpu_ckpt_chunks_dedup_hits_total")
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        free = shutil.disk_usage(root).free
        print(json.dumps({"phase": "checkpoint_disk", "root": root,
                          "free_bytes": free, "weights_bytes": nbytes}),
              flush=True)
        if free < 1.05 * nbytes:
            fail(f"checkpoint: {free} bytes free under {root}, the "
                 f"weights need {nbytes}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng.model.save_checkpoint(root)
        save_s = time.perf_counter() - t0
        st = CheckpointStore(root)
        ents = st.latest_manifest()["arrays"]
        chunks = sum(len(e["chunks"]) for e in ents.values())
        on_disk = st.chunks.all_digests()
        w0, d0 = written.value, dedup.value
        t0 = time.perf_counter()
        eng.model.save_checkpoint(root)
        resave_s = time.perf_counter() - t0
        new_chunks = int(written.value - w0)
        hits = int(dedup.value - d0)
        if new_chunks or hits != chunks or st.steps() != [1, 2] \
                or st.chunks.all_digests() != on_disk:
            fail(f"checkpoint: the unchanged second save wrote "
                 f"{new_chunks} chunks and hit {hits} of {chunks}")
        t0 = time.perf_counter()
        eng2 = Engine.from_checkpoint(root, **kw)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        got = [r.result().tolist() for r in serve_mix(eng2, mix)]
        if got != want:
            bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
            fail(f"checkpoint: the engine built from the checkpoint "
                 f"differs from phase 3 on requests {bad}")
        del eng2
        gc.collect()
        torch.cuda.empty_cache()
        zeros = {k: torch.zeros_like(v) for k, v in params.items()
                 if k != "blocks"}
        zeros["blocks"] = [{k: torch.zeros_like(v) for k, v in b.items()}
                           for b in params["blocks"]]
        eng3 = Engine(GPTDecodeModel(cfg, params=zeros), **kw)
        probe = np.random.RandomState(99).randint(0, cfg.vocab_size, (20,))
        with eng3:                      # the scheduler thread serves
            busy = eng3.submit(probe, 64)
            t0 = time.perf_counter()
            eng3.warm_start(root, version=7)
            warm_s = time.perf_counter() - t0
            busy.result(300)
        version = eng3.stats()["model_version"]
        got3 = [r.result().tolist() for r in serve_mix(eng3, mix)]
        peak = torch.cuda.max_memory_allocated()
        del eng3, zeros
        gc.collect()
        torch.cuda.empty_cache()
        row = {"phase": "checkpoint", "config": "gpt3_1p3b f32, 1 MiB "
               "chunks, engine of phase 3", "bytes": nbytes,
               "arrays": len(ents), "chunks": chunks,
               "save_s": round(save_s, 3),
               "save_gb_per_s": round(nbytes / save_s / 1e9, 3),
               "resave_s": round(resave_s, 3),
               "resave_gb_per_s": round(nbytes / resave_s / 1e9, 3),
               "resave_chunks_written": new_chunks,
               "resave_dedup_hits": hits,
               "from_checkpoint_s": round(restore_s, 3),
               "from_checkpoint_gb_per_s": round(nbytes / restore_s / 1e9,
                                                 3),
               "warm_start_s": round(warm_s, 3),
               "warm_start_gb_per_s": round(nbytes / warm_s / 1e9, 3),
               "warm_start_during_request": busy.status,
               "model_version": version,
               "tokens_equal_phase3": got == want,
               "warm_tokens_equal_phase3": got3 == want,
               "max_memory_allocated_gb": round(peak / 1e9, 3)}
        print(json.dumps(row), flush=True)
        if got3 != want:
            bad = [i for i, (g, w) in enumerate(zip(got3, want)) if g != w]
            fail(f"checkpoint: the warm-started engine differs from "
                 f"phase 3 on requests {bad}")
        if version != 7 or busy.status != "done":
            fail(f"checkpoint: warm start left model_version {version}, "
                 f"the in-flight request {busy.status}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def serving_wide_heads_phase(torch):
    """Decode at a head width past the vector paged kernel, on the card:
    a 2-layer GPT with heads of 256 (hidden 512, 2 heads; the reference
    serves it through paged_attention_xla, the vector kernel takes
    head_dim <= 128) served through Engine from seeded weights: five
    greedy requests, one sharing a 2-page prefix with another so that
    prefill_tail runs too. Every request must end "done", every
    paged-attention launch must take the scalar kernel, and each
    request's tokens must equal those of the same weights served by the
    plain versions (composed blocks, attn_impl="plain"). Returns the
    run's launch counts."""
    import numpy as np
    from paddle_tpu_torch.models.gpt import GPTConfig, init_gpt_params
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    from paddle_tpu_torch.serving import Engine, GPTDecodeModel
    cfg = GPTConfig(vocab_size=8192, hidden_size=512, num_layers=2,
                    num_heads=2, max_position_embeddings=512)
    model = GPTDecodeModel(cfg, params=init_gpt_params(cfg, seed=2))
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, cfg.vocab_size, (n,))
               for n in (64, 16, 31, 100, 64)]
    prompts[4][:32] = prompts[0][:32]
    news = [16, 24, 12, 20, 16]

    def serve(m, **kw):
        eng = Engine(m, num_slots=4, num_pages=64, page_size=16, **kw)
        first = eng.submit(prompts[0], news[0])
        eng.step()             # prefill request 0 so its pages are cached
        reqs = [first] + [eng.submit(p, n)
                          for p, n in zip(prompts[1:], news[1:])]
        eng.run_until_idle()
        torch.cuda.synchronize()
        return eng, reqs

    reset_launch_counts()
    t0 = time.perf_counter()
    eng, reqs = serve(model, prefix_cache_pages=16)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    bad = [(r.id, r.status, r.error) for r in reqs if r.status != "done"]
    if bad:
        fail(f"d=256 serving: requests not done: {bad}")
    plain_model = GPTDecodeModel(dataclasses.replace(cfg,
                                                     fused_blocks=False),
                                 params=model.params, attn_impl="plain")
    _, plain = serve(plain_model)
    got = [r.result().tolist() for r in reqs]
    want = [r.result().tolist() for r in plain]
    st = eng.stats()
    print(json.dumps({"phase": "serving_wide_heads",
                      "config": "hidden=512 heads=2 head_dim=256 layers=2 "
                                "f32 pools, pages of 16",
                      "requests": len(reqs), "wall_s": round(wall, 3),
                      "prefix_cache": st["prefix_cache"],
                      "compiles": st["compiles"], "launches": counts,
                      "tokens_equal_plain": got == want}), flush=True)
    if counts.get("paged_attention", 0) <= 0 \
            or counts.get("paged_attention.scalar", 0) \
            != counts["paged_attention"]:
        fail(f"d=256 serving: paged attention must take the scalar kernel "
             f"only: {counts}")
    if not any(k.startswith("prefill_tail") for k in st["compiles"]):
        fail(f"d=256 serving: no prefill_tail call: {st['compiles']}")
    if got != want:
        fail(f"d=256 serving: greedy tokens differ from the plain "
             f"versions': {got} vs {want}")
    return counts


def prefill_kind(rows):
    """The key of a prefill call of `rows` rows in sub_block_routes:
    at most _STREAM_MAX_ROWS (the stream route's), fewer than
    _FFMA_MIN_ROWS (SIMT's), or at least that (FFMA's)."""
    from paddle_tpu_torch.ops.fused_block import (_FFMA_MIN_ROWS,
                                                  _STREAM_MAX_ROWS)
    if rows >= _FFMA_MIN_ROWS:
        return f"prefill_ge_{_FFMA_MIN_ROWS}"
    if rows <= _STREAM_MAX_ROWS:
        return f"prefill_le_{_STREAM_MAX_ROWS}"
    return f"prefill_lt_{_FFMA_MIN_ROWS}"


def tap_sub_block_routes(model):
    """Wraps the model's prefill, prefill_tail and decode (instance
    attributes over the class's) to add up the sub-blocks' launches by
    route for each kind of call: "decode", and prefill by prefill_kind.
    Returns that (live) dict."""
    from paddle_tpu_torch.ops import launch_counts
    by_call = {}

    def tap(fn, kind):
        def run(params, cache, tokens, *rest):
            before = launch_counts()
            out = fn(params, cache, tokens, *rest)
            after = launch_counts()
            key = kind if kind == "decode" \
                else prefill_kind(tokens.shape[0])
            ent = by_call.setdefault(key, {})
            for k, v in after.items():
                if k.startswith(("fused_out_ln.", "fused_ffn_ln.")) \
                        and v != before.get(k, 0):
                    ent[k] = ent.get(k, 0) + v - before.get(k, 0)
            return out
        return run

    for name, kind in (("prefill", "prefill"), ("prefill_tail", "prefill"),
                       ("decode", "decode")):
        setattr(model, name, tap(getattr(model, name), kind))
    return by_call


def check_serving_routes(by_call):
    """Every decode launch of the sub-blocks on the stream route, every
    prefill launch on its rows' route (stream up to _STREAM_MAX_ROWS,
    SIMT below _FFMA_MIN_ROWS, FFMA from there), and at least one
    decode, one prefill below _FFMA_MIN_ROWS and one at or above."""
    from paddle_tpu_torch.ops.fused_block import (_FFMA_MIN_ROWS,
                                                  _STREAM_MAX_ROWS)
    short = (f"prefill_le_{_STREAM_MAX_ROWS}", f"prefill_lt_{_FFMA_MIN_ROWS}")
    if not any(by_call.get(k) for k in short):
        fail(f"serving path: no prefill below {_FFMA_MIN_ROWS} rows "
             f"({by_call})")
    for key, route, needed in (
            ("decode", "stream", True),
            (f"prefill_ge_{_FFMA_MIN_ROWS}", "ffma", True),
            (short[0], "stream", False), (short[1], "simt", False)):
        got = by_call.get(key, {})
        bad = {k: v for k, v in got.items() if not k.endswith(f".{route}")}
        if bad or (needed and not got):
            fail(f"serving path: {key} launches {got}, all expected on the "
                 f"{route} route")


def profile_steps(torch, run, steps, what, top_n=12):
    """Device time by kernel over `steps` calls of run(): each kernel's
    ms and launches per step, and the device's busy share of the wall
    time; beside them, the device time of each of the port's own kernels
    (port_kernels, however far down the list) and the port's launch
    counters over the same calls (a kernel the profiler lists fewer times
    than its wrapper counted is missing from the busy time). One more
    call runs first under the profiler's warm-up, traced and dropped: a
    trace that starts cold loses its first kernels."""
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
    port = sorted((kv for kv in by_name.items()
                   if kv[0].startswith(PORT_KERNEL_NAMES)),
                  key=lambda kv: -kv[1][0])
    print(json.dumps({
        "phase": "profile", "what": what, "steps": steps,
        "wall_ms_per_step": round(wall * 1e3 / steps, 3),
        "device_busy_ms_per_step": round(busy / steps, 3),
        "device_busy_share": round(busy / (wall * 1e3), 4),
        "top_kernels": [{"name": k, "ms_per_step": round(v[0] / steps, 4),
                         "launches_per_step": v[1] / steps}
                        for k, v in top],
        "port_kernels": [{"name": k, "ms_per_step": round(v[0] / steps, 4),
                          "launches_per_step": v[1] / steps}
                         for k, v in port],
        "port_launches_per_step": counted}), flush=True)
    return {k: (v[0] / steps, v[1] / steps) for k, v in by_name.items()}


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
            # the peak of the bytes the tensors asked for: what
            # max_memory_allocated counts less the caching allocator's
            # rounding of blocks (up to 1 MiB a large block)
            "max_memory_requested_gb": round(torch.cuda.memory_stats()[
                "requested_bytes.all.peak"] / 1e9, 6),
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
    # each layer runs both sub-blocks and flash forward and again in its
    # remat, and the two flash backward kernels once
    L = cfg.num_layers * steps
    off_route(counts, {"fused_out_ln": 2 * L, "fused_ffn_ln": 2 * L,
                       "flash_fwd": 2 * L, "flash_bwd_dq": L,
                       "flash_bwd_dkv": L}, "GPT training path")
    return counts, step, ids


def off_route(counts, want, what, route="tc"):
    """Fails unless each kernel in `want` launched exactly that often, all
    of them on `route` (one of the kernel's routes in design_of)."""
    off = {k: (counts.get(k, 0), counts.get(f"{k}.{route}", 0), n)
           for k, n in want.items()
           if not counts.get(k, 0) == counts.get(f"{k}.{route}", 0) == n}
    if off:
        fail(f"{what}: launches (all, on the {route} route, expected) off "
             f"the {route} route: {off}")


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
    and attention in bf16, where the kernels round the unnormalised P
    blockwise as the reference does and the composed chain rounds the
    softmax: the curves agree to bf16 precision, within `rtol`
    relative."""
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
            # the peak of the bytes the tensors asked for: what
            # max_memory_allocated counts less the caching allocator's
            # rounding of blocks (up to 1 MiB a large block)
            "max_memory_requested_gb": round(torch.cuda.memory_stats()[
                "requested_bytes.all.peak"] / 1e9, 6),
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
    # attention runs in bf16 under O1: every flash launch on the tensor
    # cores; the sub-blocks stay f32 at M = 2048 tokens: every launch on
    # the FFMA route
    off_route(counts, {k: BERT_LAUNCHES_PER_STEP[k] * steps for k in
                       ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")},
              "BERT training path")
    off_route(counts, {k: BERT_LAUNCHES_PER_STEP[k] * steps for k in
                       ("fused_out_ln", "fused_ffn_ln")},
              "BERT training path", "ffma")
    # layer norm (f32 under O1, C = 768, R = 2048 and 304): the warp route
    off_route(counts, {k: BERT_LAUNCHES_PER_STEP[k] * steps for k in
                       ("layer_norm_fwd", "layer_norm_bwd_dx")},
              "BERT training path", "warp")
    return counts, step, batch


def encoder_layer_phase(torch):
    """One TransformerEncoderLayer(768, 12, 3072) with the constructor's
    defaults (relu, act_dropout = dropout = 0.1, post-LN) in training
    mode, forward and backward at (16, 128, 768) in f32: the activation
    dropout keeps the FFN off the one-kernel block, so its epilogue is
    the dropout + residual + layer norm kernel pair, both on the warp
    route (ENCODER_LAYER_LAUNCHES: any other count fails). Kernels
    against the composed chains under the same step seed: output and
    every gradient within 1e-3 + 1e-3 |ref| (f32 GEMMs of 768 and 3072
    terms in other orders through the layer). Returns the run's launch
    counts."""
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
    H = 2048, I = 8192), gelu and relu; and the preset once more in f32
    and in bf16 with x (and every copy the timing makes) 8 bytes off a
    16-byte boundary, gelu, which only the SIMT kernel takes. Each row
    names the route it took and fails on another (f32 at these shapes
    on ``ffma``, bf16 on ``tc``, misaligned on ``simt``), checks a
    bit-identical rerun, and gives device time a call (tc_times: the
    kernel, the plain version and the library chain) beside one call by
    events (call_ms); the f32 preset also the time on every pair of FFMA
    tiles (tile_ms). Tolerance: f32 sums of 768
    and 3072 terms in other orders, |err| <= 1e-4 + 1e-4 |ref|; bf16
    rounds hid and y once each in both (2**-8 relative), 2e-2 + 2e-2
    |ref|. The library yardstick is addmm, the activation, addmm
    (cuBLAS, TF32 off for f32)."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.fused_ffn import ffn_reference, fused_ffn
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(FFN_M, FFN_H, FFN_I, f32, False),
             (FFN_M, FFN_H, FFN_I, bf16, False),
             (2048, 768, 3072, f32, False), (2048, 768, 3072, bf16, False),
             (1024, 2048, 8192, bf16, False),
             (FFN_M, FFN_H, FFN_I, f32, True),
             (FFN_M, FFN_H, FFN_I, bf16, True)]
    g = torch.Generator(device="cuda").manual_seed(4)
    for M, H, I, dt, off in cases:
        def rn(*shape, sc=1.0):
            return (torch.randn(*shape, generator=g, device="cuda")
                    * sc).to(dt)
        x, w1, b1 = rn(M, H), rn(H, I, sc=0.02), rn(I, sc=0.02)
        w2, b2 = rn(I, H, sc=0.02), rn(H, sc=0.02)
        if off:
            x = misaligned(x)
        isz = 4 if dt == torch.float32 else 2
        tol = {"atol": 1e-4, "rtol": 1e-4} if dt == torch.float32 \
            else {"atol": 2e-2, "rtol": 2e-2}
        nbytes = isz * (M * H + H * I + I + I * H + H + M * H)
        bms, by = bound(nbytes, 4 * M * H * I + 10 * M * I,
                        F32_FLOPS if dt == torch.float32 else BF16_FLOPS)
        name = "f32" if dt == torch.float32 else "bf16"
        want = "simt" if off else "ffma" if dt == torch.float32 else "tc"
        for act in ("gelu",) if off else ("gelu", "relu"):
            y, route = routed("fused_ffn", lambda: fused_ffn(
                x, w1, b1, w2, b2, act), want)
            ref = ffn_reference(x, w1, b1, w2, b2, act)
            again = fused_ffn(x, w1, b1, w2, b2, act)
            torch.cuda.synchronize()
            if not torch.equal(y, again):
                fail(f"fused_ffn M={M} {name} {act}: two runs differ")

            def lib(x, w1, b1, w2, b2, act):
                u = torch.addmm(b1, x, w1)
                u = F.gelu(u) if act == "gelu" else torch.relu(u)
                return torch.addmm(b2, u, w2)

            row = {"kernel": "fused_ffn",
                   "shape": f"M={M} H={H} I={I} "
                            f"{'misaligned x ' if off else ''}{name} {act}",
                   "route": route, "max_abs_err": max_err(y, ref),
                   "tol": tol, "bit_identical_rerun": True,
                   **tc_times(torch, timer, (x, w1, b1, w2, b2, act),
                              fused_ffn, ffn_reference, lib,
                              clone=misaligned if off else None),
                   "bound_ms": bms, "bound_by": by}
            if route == "ffma" and M == FFN_M and act == "gelu":
                row["tile_ms"] = ffma_tile_ms(torch, timer, "fused_ffn", (
                    x, w1, b1, w2, b2, act))
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
    times a step, every launch on the FFMA route; the peak of allocated
    device memory over the steps is printed; the same steps from the same start under
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
    torch.cuda.reset_peak_memory_stats()
    losses, times, sc = train()
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
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
        "peak_memory_gb": round(peak_gb, 3),
        "launches": counts, "launches_predicted": {
            "fused_ffn": FFN_LAUNCHES_PER_STEP * FFN_STEPS,
            "fused_ffn.ffma": FFN_LAUNCHES_PER_STEP * FFN_STEPS},
        "composed_launches": composed_counts,
        "eager_run_op": {"launches": eager, "max_abs_err": eager_err},
        "executor": exe.stats()}), flush=True)
    if not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < losses[0]:
        fail(f"static FFN loss did not fall: {losses}")
    for name in ("fused_ffn", "fused_ffn.ffma"):
        if counts.get(name, 0) != FFN_LAUNCHES_PER_STEP * FFN_STEPS:
            fail(f"static FFN: {name} launched {counts.get(name, 0)} times, "
                 f"predicted {FFN_LAUNCHES_PER_STEP * FFN_STEPS} (launches "
                 f"by route {route_counts(counts, 'fused_ffn')})")
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


def resnet_loss(m, img, label):
    from paddle_tpu_torch.nn import functional as F
    return F.cross_entropy(m(img), label)


def separable_batches(steps):
    """tests/test_vision_models.py's class-separable images: 4 fixed
    patterns plus noise, 16 fresh labels each step, 32 x 32."""
    import numpy as np
    rng = np.random.RandomState(0)
    protos = rng.randn(4, 3, 32, 32).astype("float32") * 2
    out = []
    for _ in range(steps):
        lab = rng.randint(0, 4, (16,))
        img = protos[lab] + rng.randn(16, 3, 32, 32).astype("float32") * .1
        out.append((img, lab[:, None].astype("int64")))
    return out


def resnet_parity(torch, steps=3, lr=0.01):
    """resnet18 (10 classes, NHWC, weights from the port's initialisers at
    seed 0) at 32 x 32, batch 8, f32: `steps` momentum steps through
    make_train_step on the card and the same steps on the CPU. Every
    step's loss must agree within 1e-3 relative and every running
    statistic within 1e-4 + 1e-4 relative. lr 0.01: at lr 0.1 on random
    labels the untrained net's loss climbs (4.4 to 14.5 in 3 steps) and
    two float32 sum orders part by 1% (seen on the CPU between the NCHW
    and NHWC trunks); at 0.01 they agree to 2e-5. Then under O1, on the
    card, the class-separable recipe (lr 0.01, 6 steps): the last loss
    below the first (at the reference test's lr 0.05 the loss swings
    from 0.01 to 16 between steps on the CPU)."""
    import math
    import numpy as np
    from paddle_tpu_torch.jit import make_train_step
    from paddle_tpu_torch.nn import initializer
    from paddle_tpu_torch.vision.models import resnet18
    rng = np.random.RandomState(0)
    batches = [(rng.randn(8, 3, 32, 32).astype("float32"),
                rng.randint(0, 10, (8, 1)).astype("int64"))
               for _ in range(steps)]
    initializer.seed(0)
    model = resnet18(num_classes=10, data_format="NHWC").train()
    runs = {}
    for dev in ("cuda", "cpu"):
        step = make_train_step(model, resnet_loss, optimizer="momentum",
                               lr=lr, device=dev)
        losses = [float(step(*(torch.as_tensor(a, device=dev)
                               for a in b))) for b in batches]
        runs[dev] = (losses, {n: v.cpu() for n, v in step.buffers.items()})
    (gl, gb), (cl, cb) = runs["cuda"], runs["cpu"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
    buf_err = max(max_err(gb[n], cb[n]) for n in gb)
    moved = sum(not torch.equal(gb[n], v) for n, v in
                model.named_buffers())
    bad = [n for n in gb if not within(gb[n], cb[n], 1e-4, 1e-4)]
    torch.cuda.empty_cache()
    initializer.seed(0)
    amp_model = resnet18(num_classes=4, data_format="NHWC").train()
    step = make_train_step(amp_model, resnet_loss, optimizer="momentum",
                           lr=lr, amp_level="O1")
    amp_losses = [float(step(*(torch.as_tensor(a, device="cuda")
                               for a in b)))
                  for b in separable_batches(6)]
    print(json.dumps({
        "phase": "resnet_parity", "config": "resnet18 NHWC 32x32 batch 8 "
        f"f32 momentum lr={lr}, card against CPU; O1 separable",
        "losses_cuda": gl, "losses_cpu": cl, "max_rel": rel,
        "buffers_max_abs_err": buf_err, "buffers_moved": moved,
        "buffers": len(gb), "o1_separable_losses": amp_losses}),
        flush=True)
    if not rel <= 1e-3:
        fail(f"resnet18 card and CPU losses differ: {gl} against {cl}")
    if bad:
        fail(f"resnet18 running statistics differ between card and CPU: "
             f"{bad[:4]} (max abs err {buf_err})")
    if moved != len(gb):
        fail(f"resnet18: {len(gb) - moved} running statistics did not move")
    if not all(math.isfinite(v) for v in amp_losses) \
            or not amp_losses[-1] < amp_losses[0]:
        fail(f"resnet18 O1 loss did not fall: {amp_losses}")


def resnet50_phase(torch, with_profile=False):
    """bench.py's bench_resnet50 through the port: resnet50 (1000
    classes, NHWC), make_train_step(optimizer="momentum", lr=0.1,
    amp_level="O1"), a batch of 256 x 3 x 224 x 224 from
    np.random.RandomState(0) with labels randint(0, 1000, (256, 1)),
    resident on the card; RESNET_WARMUP warm-up steps, then
    RESNET_STEPS steps each timed to a synchronize. The loss must stay
    finite, every running statistic must move, the stem's convolution
    must hand back an NHWC-contiguous tensor, and no kernel of the port
    launches (the launch counts of the timed steps are all zero)."""
    import math
    import numpy as np
    from paddle_tpu_torch.jit import make_train_step
    from paddle_tpu_torch.nn import initializer
    from paddle_tpu_torch.observability.perf import \
        resnet_train_flops_per_step
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    from paddle_tpu_torch.vision.models import resnet50
    t0 = time.perf_counter()
    initializer.seed(0)
    model = resnet50(num_classes=1000, data_format="NHWC").train()
    step = make_train_step(model, resnet_loss, optimizer="momentum",
                           lr=0.1, amp_level="O1")
    init_s = time.perf_counter() - t0
    rng = np.random.RandomState(0)
    img = torch.as_tensor(rng.randn(RESNET_BATCH, 3, 224, 224).astype(
        "float32"), device="cuda")
    lab = torch.as_tensor(rng.randint(0, 1000, (RESNET_BATCH, 1)).astype(
        "int64"), device="cuda")
    start = {n: v.clone() for n, v in step.buffers.items()}
    stem = []
    hook = model.stem[0].register_forward_hook(
        lambda mod, args, out: stem.append((tuple(out.shape), out.stride(),
                                            out.is_contiguous(), out.dtype)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    warm = []
    for _ in range(RESNET_WARMUP):
        t0 = time.perf_counter()
        loss = float(step(img, lab))
        warm.append([loss, round((time.perf_counter() - t0) * 1e3, 3)])
    hook.remove()
    torch.cuda.synchronize()
    reset_launch_counts()
    losses, times = [], []
    for _ in range(RESNET_STEPS):
        t0 = time.perf_counter()
        loss = step(img, lab)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    counts = launch_counts()
    step_s = statistics.median(times)
    flops = resnet_train_flops_per_step(RESNET_BATCH)
    moved = {n: float((step.buffers[n] - v).abs().max())
             for n, v in start.items()}
    main_d = {
        "phase": "resnet50_phase", "config": "bench_resnet50: resnet50 "
        "NHWC, 1000 classes, momentum lr=0.1, O1", "batch": RESNET_BATCH,
        "image": [3, 224, 224], "init_s": round(init_s, 2),
        "warmup_loss_ms": warm, "losses": losses,
        "step_ms": [round(t * 1e3, 3) for t in times],
        "step_ms_median": round(step_s * 1e3, 3),
        "images_per_s": round(RESNET_BATCH / step_s, 2),
        "mfu_bf16": round(flops / step_s / BF16_FLOPS, 5),
        "flops_per_step": flops,
        "max_memory_allocated_gb": round(
            torch.cuda.max_memory_allocated() / 1e9, 3),
        "max_memory_requested_gb": round(torch.cuda.memory_stats()[
            "requested_bytes.all.peak"] / 1e9, 6),
        "stem_output": {"shape": stem[0][0], "stride": stem[0][1],
                        "contiguous": stem[0][2], "dtype": str(stem[0][3])},
        "buffers": len(moved),
        "buffers_moved": sum(v > 0 for v in moved.values()),
        "buffer_max_abs_change": max(moved.values()),
        "port_launches": counts}
    print(json.dumps(main_d), flush=True)
    if not all(math.isfinite(v) for v in losses):
        fail(f"non-finite ResNet-50 loss: {losses}")
    if not stem[0][2] or stem[0][0] != (RESNET_BATCH, 112, 112, 64):
        fail(f"ResNet-50 stem output not NHWC-contiguous: {stem[0]}")
    if main_d["buffers_moved"] != len(moved):
        fail(f"ResNet-50: {len(moved) - main_d['buffers_moved']} running "
             f"statistics did not move")
    if any(counts.values()):
        fail(f"ResNet-50 launched kernels of the port: {counts}")
    if with_profile:
        table = profile_steps(torch, lambda: step(img, lab), 1,
                              "resnet50_train_step", top_n=16)
        kinds = {"layout": LAYOUT_KERNELS, "copy": COPY_KERNELS}
        row = {"phase": "resnet50_layout",
               "busy_ms": round(sum(v[0] for v in table.values()), 3)}
        for kind, words in kinds.items():
            hit = {k: v for k, v in table.items()
                   if any(w in k for w in words)}
            row[f"{kind}_kernels"] = {
                k: {"ms": round(v[0], 4), "launches": v[1]}
                for k, v in sorted(hit.items(), key=lambda kv: -kv[1][0])}
            row[f"{kind}_ms"] = round(sum(v[0] for v in hit.values()), 4)
        print(json.dumps(row), flush=True)


def widedeep_parity(torch, steps=3, tol=1e-4):
    """WideDeepConfig.tiny(), batch 64, Adam lr 1e-3: `steps` steps of
    WideDeepTrainStep on the card and the same on the CPU, from the same
    seed and batches. Every loss within `tol` relative, every parameter
    and both Adam moments within `tol` relative (+ 1e-6)."""
    import numpy as np
    from paddle_tpu_torch.models.wide_deep import (WideDeepConfig,
                                                   WideDeepTrainStep,
                                                   _leaves)
    cfg = WideDeepConfig.tiny()
    rng = np.random.RandomState(0)
    batches = []
    for _ in range(steps):
        ids = rng.randint(0, cfg.vocab_size, (64, cfg.num_slots))
        batches.append((ids, rng.randn(64, cfg.dense_dim).astype(
            np.float32), (ids[:, 0] % 2).astype(np.float32)[:, None]))
    runs = {}
    for dev in ("cuda", "cpu"):
        step = WideDeepTrainStep(cfg, device=dev)
        losses = [float(step(*b)) for b in batches]
        state = _leaves(step.params) + [m for st in _leaves(step.opt_state)
                                        for m in (st["m1"], st["m2"])]
        runs[dev] = (losses, [t.cpu() for t in state])
    (gl, gs), (cl, cs) = runs["cuda"], runs["cpu"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
    err = max(max_err(a, b) for a, b in zip(gs, cs))
    bad = sum(not within(a, b, 1e-6, tol) for a, b in zip(gs, cs))
    print(json.dumps({"phase": "widedeep_parity", "config": "tiny, batch "
                      f"64, adam lr 1e-3, {steps} steps, card against CPU",
                      "losses_cuda": gl, "losses_cpu": cl, "max_rel": rel,
                      "state_max_abs_err": err, "tensors": len(gs),
                      "tensors_outside": bad}), flush=True)
    if not rel <= tol or bad:
        fail(f"wide&deep card and CPU differ: losses {gl} against {cl}, "
             f"{bad} of {len(gs)} parameters or moments outside {tol}")


def widedeep_phase(torch, with_profile=False):
    """bench.py's bench_widedeep headline path whole: WideDeepConfig()
    (1,048,576-row hashed vocab, 26 slots, embed 16, 13 dense features,
    hidden 400-400-400), WideDeepTrainStep(dp=1, mp=1), Adam lr 1e-3,
    f32, batch WD_BATCH of the bench's seeded ids, dense features and
    ids[:, 0] % 2 labels, handed over as numpy arrays each step as the
    bench does. WD_WARMUP warm-up steps, then WD_STEPS timed ones: the
    bench's examples/s (one synchronize after the block) and the median
    of the steps' spans between CUDA events. Then the same count of
    steps on inputs already on the card (resident_*). The loss must be
    finite and lower after the warm-up and timed steps than after the
    first, and no kernel of the port launches."""
    import numpy as np
    from paddle_tpu_torch.models.wide_deep import (WideDeepConfig,
                                                   WideDeepTrainStep)
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    cfg = WideDeepConfig()
    t0 = time.perf_counter()
    step = WideDeepTrainStep(cfg, dp=1, mp=1)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, (WD_BATCH, cfg.num_slots))
    dense = rng.randn(WD_BATCH, cfg.dense_dim).astype(np.float32)
    label = (ids[:, 0] % 2).astype(np.float32)[:, None]
    torch.cuda.reset_peak_memory_stats()
    losses = [step(ids, dense, label) for _ in range(WD_WARMUP)]
    torch.cuda.synchronize()
    reset_launch_counts()

    def block(args):
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(WD_STEPS + 1)]
        out = []
        t0 = time.perf_counter()
        marks[0].record()
        for i in range(WD_STEPS):
            out.append(step(*args))
            marks[i + 1].record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        spans = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        return out, wall, statistics.median(spans)

    timed, wall, med = block((ids, dense, label))
    counts = launch_counts()
    losses = [float(v) for v in losses + timed]
    dev = [torch.as_tensor(a, device=step.device)
           for a in (ids, dense, label)]
    _, r_wall, r_med = block(dev)
    row = {
        "phase": "widedeep_phase", "config": "bench_widedeep: vocab "
        f"{cfg.vocab_size}, {cfg.num_slots} slots, embed {cfg.embed_dim}, "
        f"{cfg.dense_dim} dense, hidden {list(cfg.hidden)}, f32, adam "
        "lr 1e-3, dense tables", "batch": WD_BATCH,
        "warmup": WD_WARMUP, "steps": WD_STEPS, "init_s": round(init_s, 3),
        "losses": losses,
        "examples_per_s": round(WD_BATCH * WD_STEPS / wall, 1),
        "step_ms_median": round(med, 4),
        "resident_examples_per_s": round(WD_BATCH * WD_STEPS / r_wall, 1),
        "resident_step_ms_median": round(r_med, 4),
        "max_memory_allocated_gb": round(
            torch.cuda.max_memory_allocated() / 1e9, 3),
        "max_memory_requested_gb": round(torch.cuda.memory_stats()[
            "requested_bytes.all.peak"] / 1e9, 6),
        "port_launches": counts}
    print(json.dumps(row), flush=True)
    if not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < losses[0]:
        fail(f"wide&deep loss did not fall: {losses}")
    if any(counts.values()):
        fail(f"wide&deep launched kernels of the port: {counts}")
    if with_profile:
        profile_steps(torch, lambda: step(ids, dense, label), 3,
                      "widedeep_train_step", top_n=16)


def profile_static(torch, exe, main, fetch, feed, what, steps=3):
    """Device-time breakdown of `steps` static steps."""
    profile_steps(torch, lambda: exe.run(main, feed=feed, fetch_list=fetch,
                                         return_numpy=False), steps, what,
                  top_n=12)


def design_of(name):
    """The routes (and their designs) of the kernel `name`."""
    if name.startswith("flash"):
        return FLASH_DESIGN
    if name.startswith("layer_norm"):
        return LN_DESIGN
    if name.startswith("dropout_add_ln"):
        return DAL_DESIGN
    if name == "paged_attention":
        return PAGED_DESIGN
    return FFN_DESIGN if name == "fused_ffn" else DESIGN


def route_counts(counts, name):
    """The launches of `name` on each of its routes in a path's counts."""
    return {r: counts.get(f"{name}.{r}", 0) for r in design_of(name)}


def kernel_entry(row, launches):
    ent = {"name": row["kernel"], "route": "cuda",
           "source": SOURCE[row["kernel"]],
           "replaces": REPLACES[row["kernel"]], "launches": launches,
           "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
           "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
           "bound_by": row["bound_by"], "library_ms": row["library_ms"],
           "shape": row["shape"]}
    if "call_ms" in row:    # one wrapper call, host time included
        ent["call_ms"] = row["call_ms"]
    for key in ("device_ms",           # device time a call, no host time
                "simt_device_ms",      # the SIMT kernel on misaligned
                "simt_max_abs_err",    # copies, and the library chain
                "library_device_ms",
                "row_ms",              # rows 6-9's block-a-row kernel
                "row_max_abs_err",     # (misaligned copies) beside warp
                "rerun_bit_equal",
                "dx_is_dres"):         # row 7 at p = 0: one gradient
        if key in row:
            ent[key] = row[key]
    if "route" in row:      # which of the kernel's designs ran
        ent["design"] = f"{row['route']}: " \
            f"{design_of(row['kernel'])[row['route']]}"
    if row["kernel"] == "paged_attention":
        ent["splits"] = row["splits"]
        ent["gather_err"] = row["gather_err"]  # from the gather version
    for key in ("tile_ms", "split_ms",     # every FFMA tile (pair) / split
                "grid_ms"):                # size / LN grid, beside the
        if key in row:                     # rule's pick
            ent[key] = row[key]
    if "differ" in row:     # share of elements != the plain version's
        ent["differ"] = row["differ"]
    return ent


def kernels_line(results, serve_counts, wide_counts, train_counts,
                 bert_counts, layer_counts, ffn_counts):
    """One entry per kernel at the shape of the path it serves, with
    that path's launch count: paged attention from the serving run
    (decode, f32 cache, the vector route), its scalar route from the
    d = 256 serving run nested under "wide_heads" (its other
    instantiations under "shapes"); the flash kernels and the sub-blocks
    from the GPT training run (bf16, M = 1024), the sub-blocks with their serving
    decode numbers (f32, M = 8, the stream launches) nested under
    "serving" and their prefill numbers (f32, M = 256, the FFMA
    launches) under "serving_prefill", and all five with their
    BERT-shape numbers and the BERT run's launches nested under "bert";
    each of these with its launches by route ("routes"); the layer-norm
    kernels from the BERT run (f32, R = 2048, with the run's launches by
    route; R = 304 and bf16 under "shapes"); the dropout + residual +
    layer norm kernels from the encoder-layer phase (f32, R = 2048,
    p = 0.1, with the phase's launches by route; R = 304, bf16 and p = 0
    under "shapes"); fused_ffn from the
    static FFN program (f32, gelu, M = 8192), its other shapes nested
    under "shapes" with launches null."""
    def row(name, *keys):
        return next(r for r in results if r["kernel"] == name
                    and all(k in r["shape"] for k in keys))

    paged = kernel_entry(row("paged_attention", "ctx<=2048", "cache=f32"),
                         serve_counts.get("paged_attention", 0))
    # the serving run's own short contexts: launches counted above
    paged["serving_mix"] = kernel_entry(
        row("paged_attention", "serving mix", "cache=f32"), None)
    paged["routes"] = route_counts(serve_counts, "paged_attention")
    wide = row("paged_attention", "scalar", "q=f32 pools=f32 aligned")
    paged["wide_heads"] = kernel_entry(
        wide, wide_counts.get("paged_attention", 0))
    paged["wide_heads"]["routes"] = route_counts(wide_counts,
                                                 "paged_attention")
    paged["wide_heads"]["shapes"] = [
        kernel_entry(r, None) for r in results
        if r["kernel"] == "paged_attention" and "scalar" in r["shape"]
        and r is not wide]
    kernels = [paged]
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        ent = kernel_entry(row(name, "causal bf16"),
                           train_counts.get(name, 0))
        ent["routes"] = route_counts(train_counts, name)
        ent["bert"] = kernel_entry(row(name, "bf16", "no mask (BERT)"),
                                   bert_counts.get(name, 0))
        ent["bert"]["routes"] = route_counts(bert_counts, name)
        kernels.append(ent)
    for name in ("fused_out_ln", "fused_ffn_ln"):
        ent = kernel_entry(row(name, f"M={TRAIN_TOKENS} ", "bf16"),
                           train_counts.get(name, 0))
        ent["routes"] = route_counts(train_counts, name)
        # the serving run: decode (and the short prefills) on stream, the
        # prefill buckets of 128 rows and more on FFMA
        ent["serving"] = kernel_entry(row(name, "M=8 "),
                                      serve_counts.get(f"{name}.stream", 0))
        ent["serving_prefill"] = kernel_entry(
            row(name, "M=256 "), serve_counts.get(f"{name}.ffma", 0))
        ent["serving_routes"] = route_counts(serve_counts, name)
        ent["bert"] = kernel_entry(row(name, "f32", "(BERT"),
                                   bert_counts.get(name, 0))
        ent["bert"]["routes"] = route_counts(bert_counts, name)
        kernels.append(ent)
    for name in ("layer_norm_fwd", "layer_norm_bwd_dx"):
        top = row(name, "R=2048", "f32")
        ent = kernel_entry(top, bert_counts.get(name, 0))
        ent["routes"] = route_counts(bert_counts, name)
        # the MLM head's 304 rows and bf16: launches counted with R=2048
        ent["shapes"] = [kernel_entry(r, None) for r in results
                         if r["kernel"] == name and r is not top]
        kernels.append(ent)
    for name in ("dropout_add_ln_fwd", "dropout_add_ln_bwd"):
        top = row(name, "R=2048", "f32", "p=0.1")
        ent = kernel_entry(top, layer_counts.get(name, 0))
        ent["routes"] = route_counts(layer_counts, name)
        # R = 304, bf16 and p = 0: launches counted with the layer's shape
        ent["shapes"] = [kernel_entry(r, None) for r in results
                         if r["kernel"] == name and r is not top]
        kernels.append(ent)
    main = f"M={FFN_M} H={FFN_H} I={FFN_I} f32 gelu"
    ent = kernel_entry(row("fused_ffn", main), ffn_counts.get("fused_ffn", 0))
    ent["routes"] = route_counts(ffn_counts, "fused_ffn")
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
            if any(k in line for k in ("Compiling entry", "registers",
                                       "spill", "wgmma")):
                print(f"ptxas {name}: {line.strip()}", file=sys.stderr)

    t0 = time.perf_counter()
    timer = Timer(torch)
    results = []
    check_paged(torch, timer, results)
    check_paged_scalar(torch, timer, results)
    check_blocks(torch, timer, results)
    check_blocks_bf16(torch, timer, results)
    check_flash(torch, timer, results)
    check_rows(torch, timer, results)
    check_blocks_bert(torch, timer, results)
    check_flash_bert(torch, timer, results)
    check_ffn(torch, timer, results)
    print(json.dumps({"phase": "seconds", "of": "kernel_checks",
                      "seconds": round(time.perf_counter() - t0, 2)}),
          flush=True)
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

    serve_counts, eng, tokens = timed("serving_path", serving_path, torch,
                                      tree)
    timed("checkpoint_phase", checkpoint_phase, torch, eng, tokens)
    if with_profile:
        profile_decode(torch, eng, eng.model.cfg.vocab_size)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    wide_counts = timed("serving_wide_heads", serving_wide_heads_phase,
                        torch)
    gc.collect()
    torch.cuda.empty_cache()

    timed("train_parity", train_parity, torch, tree)
    train_counts, step, ids = timed("training_path", training_path, torch,
                                    tree)
    if with_profile:
        profile_steps(torch, lambda: step(ids), 1, "train_step", top_n=16)
    del step
    gc.collect()
    torch.cuda.empty_cache()

    timed("bert_parity", bert_parity, torch)
    bert_counts, bstep, bbatch = timed("bert_training_path",
                                       bert_training_path, torch)
    if with_profile:
        profile_steps(torch, lambda: bstep(*bbatch), 1, "bert_train_step",
                      top_n=24)
    del bstep, bbatch
    gc.collect()
    torch.cuda.empty_cache()
    layer_counts = timed("encoder_layer", encoder_layer_phase, torch)
    gc.collect()
    torch.cuda.empty_cache()

    timed("static_lenet", static_lenet_phase, torch, with_profile)
    ffn_counts = timed("static_ffn", static_ffn_phase, torch, with_profile)
    gc.collect()
    torch.cuda.empty_cache()

    timed("resnet_parity", resnet_parity, torch)
    gc.collect()
    torch.cuda.empty_cache()
    timed("resnet50_phase", resnet50_phase, torch, with_profile)
    gc.collect()
    torch.cuda.empty_cache()

    timed("widedeep_parity", widedeep_parity, torch)
    timed("widedeep_phase", widedeep_phase, torch, with_profile)

    print(json.dumps(kernels_line(results, serve_counts, wide_counts,
                                  train_counts, bert_counts, layer_counts,
                                  ffn_counts)),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])

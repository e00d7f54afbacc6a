"""Epilogue-fused decoder sub-blocks (counterpart of
``paddle_tpu/ops/pallas_block.py``).

  fused_out_ln    z = res + dropout_p(a @ W + b);  h = LN(z) * ln_s + ln_b
                  — the attention-out projection whose epilogue carries
                  bias + dropout + residual-add + layernorm, emitting the
                  new residual stream z and the normalised h.

  fused_ffn_ln    out = [LN](res + dropout_p(act([LN] x @ W1 + b1) @ W2
                  + b2)) — the whole FFN sub-block in one call; the
                  activation is rounded to x's type before the second
                  product, as the reference rounds it.
                  norm "pre" normalises x before the first GEMM, norm
                  "post" the summed output (post-LN encoders), "none"
                  neither; act is "gelu_tanh", "gelu" (the reference's
                  erf polynomial, ``gelu_erf_poly``) or "relu".

Each has a plain PyTorch version beside it (``out_ln_reference``,
``ffn_ln_reference``: ports of the JAX package's composed references),
which CPU tensors take. CUDA tensors go to the kernels in
``csrc/fused_block.cu`` or the call raises. The kernels take float32 or
bfloat16 for the activations, weights and biases (one type per call)
with float32 ln_s/ln_b, and accumulate in f32; z and the FFN output come
out in res2's type, h in a2's. Four routes, picked by dtype, row
count, widths and alignment before the launch (``tc_route``, then
``ffma_route``, then ``stream_route``, else SIMT): bfloat16 calls whose
inner widths are multiples of 64 run on the tensor cores (wgmma fed by
TMA; the FFN's hid goes through device memory in bf16); float32 calls
of at least ``_FFMA_MIN_ROWS`` rows at such widths run the same launch
sequence in f32 on a register-tiled FFMA GEMM (``csrc/ffma_tile.cuh``,
no split over K; the tile per product from ``ffma_tiles``); float32
calls of 1 to ``_STREAM_MAX_ROWS`` rows at such widths (decode, the
short prefill buckets) stream the weights (``csrc/stream_gemm.cuh``: a
block a 32-column slice and a K range, K splits from
``stream_splits``, scratch and self-resetting tickets in a per-stream
workspace, ``_launch.workspace``); everything else (ragged widths,
misaligned views, rows between the two limits) runs the SIMT kernels.
Each call counts under its op's name and under ``<name>.tc``,
``<name>.ffma``, ``<name>.stream`` or ``<name>.simt``.
Dropout is the unsalted counter hash of
``fused_residual.keep_mask`` over the (M, Dout) ids of the GEMM output,
from an int32 seed the caller hands in; no mask tensor is kept. Rows are
ragged: any M >= 1.

Both are differentiable (``torch.autograd.Function``): the forward is
the kernel (the plain version on the CPU), and the backward is the
reference's own, a composed f32 recompute of the chain under autograd
(``pallas_block.py:_out_ln_bwd`` / ``_ffn_ln_bwd``) with the dropout
mask replayed from the seed and each gradient cast to its input's type.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from ._launch import (_check, _dtype_code, _drop_args, _raise_if, _route,
                      _sms, workspace)
from .fused_residual import apply_keep

__all__ = ["fused_out_ln", "out_ln_reference", "fused_ffn_ln",
           "ffn_ln_reference", "gelu_tanh", "gelu_erf_poly", "ACTS",
           "NORMS", "out_ln_split_k", "ffn_block_i", "tc_route",
           "ffma_route", "ffma_tiles", "stream_route", "stream_rows",
           "stream_splits"]

_ROW_TILE = 32          # BM in csrc/fused_block.cu
_OUT_COL_TILE = 64      # OL_BN
_K_STAGE = 32           # BK
_FFN_COL_CHUNK = 128    # FF_BN
_TC_WIDTH = 64          # the tensor-core tiles' k step and TMA box width
_FFMA_MIN_ROWS = 128    # f32 calls from this many rows take the FFMA route
# the FFMA route's output tiles (rows, columns), by the code the launch
# takes (csrc/fused_block.cu ffma_gemm), and the blocks of each an SM
# holds (its register cap there, ffma_blocks)
_FFMA_TILES = ((128, 128), (128, 64), (64, 64))
_FFMA_BLOCKS = (2, 2, 3)
_FFMA_FILL = 0.9        # the share of a wave's resident blocks to fill
# f32 calls of 1 to this many rows take the stream route: the largest of
# {16, 32, 64, 127} at which it is no slower than SIMT at GPT-3 XL width
# on the card (chip_smoke.py's stream_max_rows sweep, PERF.md: at 127
# rows 0.080 / 0.452 ms against SIMT's 0.161 / 0.613 for out_ln / ffn_ln)
_STREAM_MAX_ROWS = 127
_STREAM_COLS = 32       # W columns a block (csrc/stream_gemm.cuh kCols)
_STREAM_K_STAGE = 64    # k rows a stage (kStage)
_STREAM_BLOCKS_PER_SM = 2   # stream_splits' target (__launch_bounds__)
_STREAM_MIN_STAGES = 2  # stages a split, at least


def gelu_tanh(v):
    """tanh-approximated gelu, the formula of pallas_ffn._gelu_tanh."""
    f = v.float()
    c = 0.7978845608028654  # sqrt(2/pi)
    return (0.5 * f * (1.0 + torch.tanh(c * (f + 0.044715 * f * f * f)))
            ).to(v.dtype)


def gelu_erf_poly(v):
    """gelu through the Abramowitz & Stegun 7.1.26 erf polynomial with
    the reference's constants (pallas_ffn._gelu_exact, |erf error| <
    1.5e-7): the function the kernel computes, not torch.erf."""
    f = v.float()
    z = f * 0.7071067811865476
    a = z.abs()
    t = 1.0 / (1.0 + 0.3275911 * a)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    erf = torch.sign(z) * (1.0 - poly * torch.exp(-a * a))
    return (0.5 * f * (1.0 + erf)).to(v.dtype)


# activation name -> (kernel code, plain function)
ACTS = {"gelu_tanh": (0, gelu_tanh), "gelu": (1, gelu_erf_poly),
        "relu": (2, torch.relu)}
NORMS = {"none": 0, "pre": 1, "post": 2}


def _act_norm(act, norm):
    if act not in ACTS:
        raise ValueError(f"fused_ffn_ln supports gelu/gelu_tanh/relu, got "
                         f"{act!r}")
    if norm not in NORMS:
        raise ValueError(f"fused_ffn_ln norm is none/pre/post, got "
                         f"{norm!r}")
    return ACTS[act][0], NORMS[norm]


def _ln_f32(z, scale, bias, eps):
    mean = z.mean(-1, keepdim=True)
    var = torch.square(z - mean).mean(-1, keepdim=True)
    return (z - mean) * torch.rsqrt(var + eps) * scale + bias


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def out_ln_reference(a2, w, b, res2, ln_s, ln_b, p=0.0, eps=1e-5, seed=0):
    """Composed chain of fused_out_ln: (z in res2.dtype, h in a2.dtype)."""
    y = apply_keep(a2.float() @ w.float() + b.float(), seed, p)
    z = y + res2.float()
    h = _ln_f32(z, ln_s.float(), ln_b.float(), eps)
    return z.to(res2.dtype), h.to(a2.dtype)


def ffn_ln_reference(x2, w1, b1, w2, b2, res2, ln_s=None, ln_b=None,
                     act="gelu_tanh", norm="none", p=0.0, eps=1e-5, seed=0):
    """Composed chain of fused_ffn_ln, in res2.dtype (ln_s/ln_b are
    unused with norm "none"). With norm "pre" the normalised x is
    rounded to x2's type before the first product, and the activation
    before the second (pallas_block.py:_ffn_ln_kernel's xn_ref and
    ``act(a).astype(x_ref.dtype)``), as the kernels round them. The
    backward (_grads_of) runs this chain on float32 copies of the
    inputs, where both roundings are the identity: the reference's
    unrounded f32 recompute (_ffn_ln_bwd)."""
    _act_norm(act, norm)
    src = x2.float()
    if norm == "pre":
        src = _ln_f32(src, ln_s.float(), ln_b.float(), eps) \
            .to(x2.dtype).float()
    hid = ACTS[act][1](src @ w1.float() + b1.float()).to(x2.dtype).float()
    y = apply_keep(hid @ w2.float() + b2.float(), seed, p)
    z = y + res2.float()
    if norm == "post":
        z = _ln_f32(z, ln_s.float(), ln_b.float(), eps)
    return z.to(res2.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def out_ln_split_k(m: int, k: int, n: int, sms: int) -> int:
    """K depth per split of fused_out_ln's SIMT kernel (a multiple of its
    k stage) on a card of `sms` multiprocessors. When the output tiles
    alone cannot fill the card (decode: M = slot count) K is split so
    that about two blocks run per SM; the partial sums are added in split
    order by the tile's last block."""
    tiles = math.ceil(m / _ROW_TILE) * math.ceil(n / _OUT_COL_TILE)
    splits = 1 if tiles >= sms else math.ceil(2 * sms / tiles)
    splits = max(1, min(splits, k // (4 * _K_STAGE)))
    return math.ceil(math.ceil(k / splits) / _K_STAGE) * _K_STAGE


def ffn_block_i(m: int) -> int:
    """Intermediate columns per block of fused_ffn_ln: 64 while the row
    tiles are few (decode), so I/64 blocks share the weight stream;
    128 otherwise, which halves the partial sums to reduce."""
    return 64 if m <= 2 * _ROW_TILE else 128


def tc_route(dtype, widths, ptrs) -> bool:
    """Whether a call takes the tensor-core kernels: bfloat16, every
    inner width (K and N of fused_out_ln, H and I of fused_ffn_ln) a
    positive multiple of 64, and every tensor's address (`ptrs`, from
    data_ptr()) 16-byte aligned, as TMA and the vector epilogue need.
    Anything else is asked ffma_route, then stream_route, then takes the
    SIMT kernels; nothing is tried and caught."""
    return (dtype == torch.bfloat16
            and all(w > 0 and w % _TC_WIDTH == 0 for w in widths)
            and all(p % 16 == 0 for p in ptrs))


def ffma_route(dtype, m, widths, ptrs) -> bool:
    """Whether a call takes the FFMA kernels: float32, at least
    _FFMA_MIN_ROWS rows (below that, decode and the short prefill
    buckets, the stream kernels spread the weight stream over more
    blocks), every inner width a positive multiple of 64 and every
    tensor's address 16-byte aligned (cp.async and the float4
    epilogue). Asked after tc_route; anything else is asked
    stream_route, then takes the SIMT kernels."""
    return (dtype == torch.float32 and m >= _FFMA_MIN_ROWS
            and all(w > 0 and w % _TC_WIDTH == 0 for w in widths)
            and all(p % 16 == 0 for p in ptrs))


def ffma_tiles(m: int, n: int, sms: int) -> tuple[int, int]:
    """The FFMA route's output tile of an (m, n) product on a card of
    `sms` multiprocessors: the largest of _FFMA_TILES whose tiles fill
    at least _FFMA_FILL of the waves of resident blocks they take (sms
    times its blocks an SM), else the smallest. A larger tile reads
    fewer bytes a FMA, but a last wave that leaves SMs idle costs more
    than that saves. At 132 SMs: BERT's (2048, 3072) takes 128 x 64
    (768 tiles, 97% of 3 waves of 264; 128 x 128 fills 73% of 2),
    (2048, 768) 64 x 64 (384 tiles, 97% of one wave of 396), GPT-3 XL
    prefill's (256, 8192) 128 x 64 (256 tiles, 97%) and (256, 2048) the
    smallest."""
    for (bm, bn), per_sm in zip(_FFMA_TILES, _FFMA_BLOCKS):
        tiles = math.ceil(m / bm) * math.ceil(n / bn)
        wave = sms * per_sm
        if tiles >= _FFMA_FILL * wave * math.ceil(tiles / wave):
            return bm, bn
    return _FFMA_TILES[-1]


def stream_route(dtype, m, widths, ptrs) -> bool:
    """Whether a call takes the stream kernels: float32, 1 to
    _STREAM_MAX_ROWS rows (decode's slots, the short prefill buckets),
    every inner width a positive multiple of 64 and every tensor's
    address 16-byte aligned (the weights and A arrive by 16-byte
    cp.async; the LN reads ln_s and ln_b as float4). Asked after
    tc_route and ffma_route; anything else takes the SIMT kernels."""
    return (dtype == torch.float32 and 1 <= m <= _STREAM_MAX_ROWS
            and all(w > 0 and w % _TC_WIDTH == 0 for w in widths)
            and all(p % 16 == 0 for p in ptrs))


def stream_rows(m: int) -> int:
    """Rows of the stream kernel's row tile for m rows (csrc/
    stream_gemm.cuh rows_a_pass): 4, 8 or 16, so that decode's 8 slots
    are not padded to a wider tile; more rows take several tiles."""
    return 4 if m <= 4 else 8 if m <= 8 else 16


def stream_splits(m: int, k: int, n: int, sms: int) -> int:
    """The K splits of the stream kernel's (m, k) @ (k, n) product on a
    card of `sms` multiprocessors, from the shapes alone (no host sync):
    enough that the grid of row tiles x n / 32 column slices x splits
    holds about _STREAM_BLOCKS_PER_SM blocks an SM, with at least
    _STREAM_MIN_STAGES stages of 64 k rows a split, and no split left
    empty when the stages are cut into ranges of ceil(stages / splits).
    At 132 SMs and m = 8: fused_out_ln's (2048, 2048) takes 4 (256
    blocks), the FFN's (2048, 8192) 1 (256 blocks) and (8192, 2048) 4."""
    tiles = math.ceil(m / stream_rows(m)) * math.ceil(n / _STREAM_COLS)
    stages = math.ceil(k / _STREAM_K_STAGE)
    want = math.floor(_STREAM_BLOCKS_PER_SM * sms / tiles + 0.5)
    want = max(1, min(want, stages // _STREAM_MIN_STAGES))
    per = math.ceil(stages / want)
    return math.ceil(stages / per)


def _stream_scratch(dev, stream, m, products):
    """Addresses of the stream kernels' f32 scratch (split partials, then
    the LN's (mean, M2) a row and 32 columns) and tickets in the
    workspace of `stream`, sized for the (k, n, splits) products of one
    call (run one after another, so they share both)."""
    rt = math.ceil(m / stream_rows(m))
    n_part = max((s * m * n if s > 1 else 0) + 2 * m * math.ceil(n / 32)
                 for _, n, s in products)
    n_tickets = max(rt * math.ceil(n / _STREAM_COLS) + rt
                    for _, n, _ in products)
    part = workspace(dev, stream, "part", n_part)
    tickets = workspace(dev, stream, "tickets", n_tickets, torch.int32)
    return part.data_ptr(), tickets.data_ptr()


def _run(dev, what, fn, *args):
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(*args, stream)
    _raise_if(err, what)


def _out_ln_kernel(a2, w, b, res2, ln_s, ln_b, eps, seed=0, p=0.0):
    m, k = a2.shape
    n = w.shape[1]
    code = _dtype_code(a2, "fused_out_ln")
    _check([("a2", a2), ("w", w), ("b", b), ("res2", res2)], a2.device,
           a2.dtype)
    _check([("ln_s", ln_s), ("ln_b", ln_b)], a2.device, torch.float32)
    if w.shape[0] != k or tuple(res2.shape) != (m, n) \
            or b.shape != (n,) or ln_s.shape != (n,) or ln_b.shape != (n,):
        raise ValueError(f"fused_out_ln shapes: a {tuple(a2.shape)}, w "
                         f"{tuple(w.shape)}, b {tuple(b.shape)}, res "
                         f"{tuple(res2.shape)}")
    z = torch.empty_like(res2)
    h = torch.empty_like(res2)
    seed, on, thr, keep_div = _drop_args(seed, p)
    ptrs = [t.data_ptr() for t in (a2, w, b, res2)]
    if tc_route(a2.dtype, (k, n), ptrs):
        zf = torch.empty((m, n), dtype=torch.float32, device=a2.device)
        fn = _build.function(
            "fused_block", "fused_out_ln_tc_launch", 9, 5,
            (ctypes.c_uint, ctypes.c_float, ctypes.c_float, ctypes.c_void_p))
        _run(a2.device, "fused_out_ln", fn, a2.data_ptr(), w.data_ptr(),
             b.data_ptr(), res2.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(),
             z.data_ptr(), zf.data_ptr(), h.data_ptr(), m, k, n, seed, on,
             thr, keep_div, float(eps))
        _build.note_launch("fused_out_ln")
        _build.note_launch("fused_out_ln.tc")
        return z, h
    if ffma_route(a2.dtype, m, (k, n), ptrs):
        tile = _FFMA_TILES.index(ffma_tiles(m, n, _sms(a2.device.index)))
        fn = _build.function(
            "fused_block", "fused_out_ln_ffma_launch", 8, 6,
            (ctypes.c_uint, ctypes.c_float, ctypes.c_float, ctypes.c_void_p))
        _run(a2.device, "fused_out_ln", fn, a2.data_ptr(), w.data_ptr(),
             b.data_ptr(), res2.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(),
             z.data_ptr(), h.data_ptr(), m, k, n, tile, seed, on, thr,
             keep_div, float(eps))
        _build.note_launch("fused_out_ln")
        _build.note_launch("fused_out_ln.ffma")
        return z, h
    if stream_route(a2.dtype, m, (k, n),
                    ptrs + [ln_s.data_ptr(), ln_b.data_ptr()]):
        splits = stream_splits(m, k, n, _sms(a2.device.index))
        stream = torch.cuda.current_stream(a2.device).cuda_stream
        part, tickets = _stream_scratch(a2.device, stream, m,
                                        [(k, n, splits)])
        fn = _build.function(
            "fused_block", "fused_out_ln_stream_launch", 10, 6,
            (ctypes.c_uint, ctypes.c_float, ctypes.c_float, ctypes.c_void_p))
        _run(a2.device, "fused_out_ln", fn, a2.data_ptr(), w.data_ptr(),
             b.data_ptr(), res2.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(),
             z.data_ptr(), h.data_ptr(), part, tickets, m, k, n, splits,
             seed, on, thr, keep_div, float(eps))
        _build.note_launch("fused_out_ln")
        _build.note_launch("fused_out_ln.stream")
        return z, h
    kc = out_ln_split_k(m, k, n, _sms(a2.device.index))
    splits = math.ceil(k / kc)
    row_tiles = math.ceil(m / _ROW_TILE)
    col_tiles = math.ceil(n / _OUT_COL_TILE)
    # the LN reads z back in f32: z itself, or an f32 copy beside a bf16 z
    zf = z if code == 0 else torch.empty(
        (m, n), dtype=torch.float32, device=a2.device)
    part = torch.empty((splits, m, n) if splits > 1 else (1,),
                       dtype=torch.float32, device=a2.device)
    tickets = torch.zeros(row_tiles * col_tiles + row_tiles,
                          dtype=torch.int32, device=a2.device)
    fn = _build.function(
        "fused_block", "fused_out_ln_launch", 11, 7,
        (ctypes.c_uint, ctypes.c_float, ctypes.c_float, ctypes.c_void_p))
    _run(a2.device, "fused_out_ln", fn, a2.data_ptr(), w.data_ptr(),
         b.data_ptr(), res2.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(),
         z.data_ptr(), zf.data_ptr(), h.data_ptr(), part.data_ptr(),
         tickets.data_ptr(), m, k, n, kc, code, seed, on, thr, keep_div,
         float(eps))
    _build.note_launch("fused_out_ln")
    _build.note_launch("fused_out_ln.simt")
    return z, h


def _ffn_kernel(x2, w1, b1, w2, b2, res2, ln_s=None, ln_b=None,
                act="gelu_tanh", norm="none", p=0.0, eps=1e-5, seed=0):
    m, hd = x2.shape
    i = w1.shape[1]
    code = _dtype_code(x2, "fused_ffn_ln")
    _check([("x2", x2), ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2),
            ("res2", res2)], x2.device, x2.dtype)
    if w1.shape[0] != hd or tuple(w2.shape) != (i, hd) \
            or b1.shape != (i,) or b2.shape != (hd,) \
            or tuple(res2.shape) != (m, hd):
        raise ValueError(f"fused_ffn_ln shapes: x {tuple(x2.shape)}, w1 "
                         f"{tuple(w1.shape)}, w2 {tuple(w2.shape)}, res "
                         f"{tuple(res2.shape)}")
    act_code, norm_code = _act_norm(act, norm)
    ln_ptrs = (0, 0)
    if norm != "none":
        _check([("ln_s", ln_s), ("ln_b", ln_b)], x2.device, torch.float32)
        if ln_s.shape != (hd,) or ln_b.shape != (hd,):
            raise ValueError(f"fused_ffn_ln: ln_s {tuple(ln_s.shape)}, ln_b "
                             f"{tuple(ln_b.shape)} for H = {hd}")
        ln_ptrs = (ln_s.data_ptr(), ln_b.data_ptr())
    out = torch.empty_like(res2)
    seed, on, thr, keep_div = _drop_args(seed, p)
    ptrs = [t.data_ptr() for t in (x2, w1, b1, w2, b2, res2)]
    if tc_route(x2.dtype, (hd, i), ptrs):
        hid = torch.empty((m, i), dtype=x2.dtype, device=x2.device)
        xn = torch.empty_like(x2) if norm == "pre" else None
        zf = torch.empty((m, hd), dtype=torch.float32, device=x2.device) \
            if norm == "post" else None
        fn = _build.function(
            "fused_block", "fused_ffn_ln_tc_launch", 12, 7,
            (ctypes.c_uint, ctypes.c_float, ctypes.c_float, ctypes.c_void_p))
        _run(x2.device, "fused_ffn_ln", fn, x2.data_ptr(), w1.data_ptr(),
             b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), res2.data_ptr(),
             *ln_ptrs, out.data_ptr(), 0 if xn is None else xn.data_ptr(),
             hid.data_ptr(), 0 if zf is None else zf.data_ptr(), m, hd, i,
             act_code, norm_code, seed, on, thr, keep_div, float(eps))
        _build.note_launch("fused_ffn_ln")
        _build.note_launch("fused_ffn_ln.tc")
        return out
    if ffma_route(x2.dtype, m, (hd, i), ptrs):
        sms = _sms(x2.device.index)
        tiles = [_FFMA_TILES.index(ffma_tiles(m, n, sms)) for n in (i, hd)]
        hid = torch.empty((m, i), dtype=torch.float32, device=x2.device)
        xn = torch.empty_like(x2) if norm == "pre" else None
        zf = torch.empty_like(res2) if norm == "post" else None
        fn = _build.function(
            "fused_block", "fused_ffn_ln_ffma_launch", 12, 9,
            (ctypes.c_uint, ctypes.c_float, ctypes.c_float, ctypes.c_void_p))
        _run(x2.device, "fused_ffn_ln", fn, x2.data_ptr(), w1.data_ptr(),
             b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), res2.data_ptr(),
             *ln_ptrs, out.data_ptr(), 0 if xn is None else xn.data_ptr(),
             hid.data_ptr(), 0 if zf is None else zf.data_ptr(), m, hd, i,
             *tiles, act_code, norm_code, seed, on, thr, keep_div,
             float(eps))
        _build.note_launch("fused_ffn_ln")
        _build.note_launch("fused_ffn_ln.ffma")
        return out
    if stream_route(x2.dtype, m, (hd, i), ptrs + list(ln_ptrs)):
        sms = _sms(x2.device.index)
        products = [(hd, i, stream_splits(m, hd, i, sms)),
                    (i, hd, stream_splits(m, i, hd, sms))]
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        part, tickets = _stream_scratch(x2.device, stream, m, products)
        hid = workspace(x2.device, stream, "hid", m * i)
        xn = workspace(x2.device, stream, "xn", m * hd).data_ptr() \
            if norm == "pre" else None
        fn = _build.function(
            "fused_block", "fused_ffn_ln_stream_launch", 13, 9,
            (ctypes.c_uint, ctypes.c_float, ctypes.c_float, ctypes.c_void_p))
        _run(x2.device, "fused_ffn_ln", fn, x2.data_ptr(), w1.data_ptr(),
             b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), res2.data_ptr(),
             *ln_ptrs, out.data_ptr(), xn, hid.data_ptr(), part, tickets,
             m, hd, i, products[0][2], products[1][2], act_code, norm_code,
             seed, on, thr, keep_div, float(eps))
        _build.note_launch("fused_ffn_ln")
        _build.note_launch("fused_ffn_ln.stream")
        return out
    bi = ffn_block_i(m)
    n_i = math.ceil(i / bi)
    row_tiles = math.ceil(m / _ROW_TILE)
    chunks = math.ceil(hd / _FFN_COL_CHUNK)
    # norm "post" reads the summed output back in f32: out itself, or an
    # f32 scratch beside a bf16 out
    zf = out if code == 0 or norm != "post" else torch.empty(
        (m, hd), dtype=torch.float32, device=x2.device)
    part = torch.empty((n_i, m, hd), dtype=torch.float32, device=x2.device)
    tickets = torch.zeros(row_tiles * chunks + row_tiles, dtype=torch.int32,
                          device=x2.device)
    fn = _build.function(
        "fused_block", "fused_ffn_ln_launch", 12, 9,
        (ctypes.c_uint, ctypes.c_float, ctypes.c_float, ctypes.c_void_p))
    _run(x2.device, "fused_ffn_ln", fn, x2.data_ptr(), w1.data_ptr(),
         b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), res2.data_ptr(),
         *ln_ptrs, out.data_ptr(), zf.data_ptr(), part.data_ptr(),
         tickets.data_ptr(), m, hd, i, bi, code, act_code, norm_code, seed,
         on, thr, keep_div, float(eps))
    _build.note_launch("fused_ffn_ln")
    _build.note_launch("fused_ffn_ln.simt")
    return out


def _grads_of(chain, saved, cots):
    """The reference's composed backward: recompute `chain` in f32 under
    autograd from the saved inputs and return each input's gradient in
    that input's dtype."""
    with torch.enable_grad():
        ins = [t.detach().float().requires_grad_() for t in saved]
        outs = chain(*ins)
        grads = torch.autograd.grad(outs, ins, [c.float() for c in cots])
    return [g.to(t.dtype) for g, t in zip(grads, saved)]


def _needs_grad(*ts):
    """Whether autograd would record a call on these inputs: grad mode on
    and some tensor requiring a gradient. When not, the entry points call
    the forward directly: the autograd.Function's bookkeeping is host time
    on every call (serving, inference) and records nothing."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def _out_ln_forward(a2, w, b, res2, ln_s, ln_b, eps, seed, p):
    if _route(a2, "fused_out_ln"):
        return _out_ln_kernel(a2, w, b, res2, ln_s, ln_b, eps, seed, p)
    return out_ln_reference(a2, w, b, res2, ln_s, ln_b, p, eps, seed)


def _ffn_forward(x2, w1, b1, w2, b2, res2, ln_s, ln_b, act, norm, p, eps,
                 seed):
    if _route(x2, "fused_ffn_ln"):
        return _ffn_kernel(x2, w1, b1, w2, b2, res2, ln_s, ln_b, act, norm,
                           p, eps, seed)
    return ffn_ln_reference(x2, w1, b1, w2, b2, res2, ln_s, ln_b, act, norm,
                            p, eps, seed)


class _OutLn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a2, w, b, res2, ln_s, ln_b, eps, seed, p):
        ctx.save_for_backward(a2, w, b, res2, ln_s, ln_b)
        ctx.args = (p, eps, seed)
        return _out_ln_forward(a2, w, b, res2, ln_s, ln_b, eps, seed, p)

    @staticmethod
    def backward(ctx, dz, dh):
        args = ctx.args
        grads = _grads_of(lambda *t: out_ln_reference(*t, *args),
                          ctx.saved_tensors, (dz, dh))
        return (*grads, None, None, None)


class _FfnLn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, w1, b1, w2, b2, res2, ln_s, ln_b, act, norm, p,
                eps, seed):
        ctx.args = (act, norm, p, eps, seed)
        # ln_s/ln_b take no part (and get no gradient) with norm "none"
        ctx.n_ln = 0 if norm == "none" else 2
        ctx.save_for_backward(x2, w1, b1, w2, b2, res2,
                              *(ln_s, ln_b)[:ctx.n_ln])
        return _ffn_forward(x2, w1, b1, w2, b2, res2, ln_s, ln_b, *ctx.args)

    @staticmethod
    def backward(ctx, dy):
        args = ctx.args

        def chain(*t):
            return ffn_ln_reference(*t, *(None, None)[ctx.n_ln:], *args)

        grads = _grads_of(chain, ctx.saved_tensors, (dy,))
        return (*grads, *(None, None)[ctx.n_ln:], None, None, None, None,
                None)


def fused_out_ln(a2, w, b, res2, ln_s, ln_b, p=0.0, eps=1e-5, seed=0):
    """a2 (M, Din) @ w (Din, Dout) + b, dropout_p, + res2, then layernorm.

    Returns (z, h): z (M, Dout) is the new residual stream, h is
    LN(z) * ln_s + ln_b. seed: the int32 of the dropout mask (unused at
    p == 0). CPU tensors take out_ln_reference. Differentiable in every
    tensor input (composed f32 backward, mask replayed)."""
    args = (a2, w, b, res2, ln_s, ln_b, float(eps), int(seed), float(p))
    if _needs_grad(*args[:6]):
        return _OutLn.apply(*args)
    return _out_ln_forward(*args)


def fused_ffn_ln(x2, w1, b1, w2, b2, res2, ln_s=None, ln_b=None,
                 act="gelu_tanh", norm="none", p=0.0, eps=1e-5, seed=0):
    """The FFN sub-block in one launch: [LN](res2 + dropout_p(act([LN] x2
    @ w1 + b1) @ w2 + b2)). ln_s/ln_b (float32) are needed with norm
    "pre" and "post" and unused with "none". CPU tensors take
    ffn_ln_reference. Differentiable in x2, w1, b1, w2, b2, res2 and the
    LN vectors in use (composed f32 backward, mask replayed)."""
    _act_norm(act, norm)
    if norm != "none" and (ln_s is None or ln_b is None):
        raise ValueError(f"fused_ffn_ln norm={norm!r} needs ln_s and ln_b")
    args = (x2, w1, b1, w2, b2, res2, ln_s, ln_b, act, norm, float(p),
            float(eps), int(seed))
    if _needs_grad(*args[:8]):
        return _FfnLn.apply(*args)
    return _ffn_forward(*args)

"""Epilogue-fused decoder sub-blocks (counterpart of
``paddle_tpu/ops/pallas_block.py``).

  fused_out_ln    z = res + a @ W + b;  h = LN(z) * ln_s + ln_b
                  — the attention-out projection whose epilogue carries
                  bias + residual-add + layernorm, emitting the new
                  residual stream z and the normalised h.

  fused_ffn_ln    out = res + act(x @ W1 + b1) @ W2 + b2
                  — the whole FFN sub-block in one launch; the (M, 4H)
                  intermediate never reaches device memory.

Each has a plain PyTorch version beside it (``out_ln_reference``,
``ffn_ln_reference``: ports of the JAX package's composed references),
which CPU tensors take. CUDA tensors go to the kernels in
``csrc/fused_block.cu`` or the call raises. The kernels take float32 or
bfloat16 for the activations, weights and biases (one type per call)
with float32 ln_s/ln_b, and accumulate in f32; z and the FFN output come
out in res2's type, h in a2's. The serving path needs p == 0, act
"gelu_tanh" and norm "none"; dropout, the other activations and the
pre/post norms come with the BERT slice and raise NotImplementedError
until then. Rows are ragged: any M >= 1.

Both are differentiable (``torch.autograd.Function``): the forward is
the kernel (the plain version on the CPU), and the backward is the
reference's own, a composed f32 recompute of the chain under autograd
(``pallas_block.py:_out_ln_bwd`` / ``_ffn_ln_bwd``) with each gradient
cast to its input's type.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["fused_out_ln", "out_ln_reference", "fused_ffn_ln",
           "ffn_ln_reference", "gelu_tanh", "out_ln_split_k", "ffn_block_i"]

_ROW_TILE = 32          # BM in csrc/fused_block.cu
_OUT_COL_TILE = 64      # OL_BN
_K_STAGE = 32           # BK
_FFN_COL_CHUNK = 128    # FF_BN
_SMS = 132              # H100 SXM streaming multiprocessors


def _unsupported(p, act="gelu_tanh", norm="none"):
    if p != 0.0:
        raise NotImplementedError(
            "dropout (p > 0) in the fused sub-blocks comes with the BERT "
            "slice of the port")
    if act != "gelu_tanh" or norm != "none":
        raise NotImplementedError(
            f"act={act!r}, norm={norm!r}: only gelu_tanh with norm 'none' "
            f"is ported; the others come with the BERT slice")


def gelu_tanh(v):
    """tanh-approximated gelu, the formula of pallas_ffn._gelu_tanh."""
    f = v.float()
    c = 0.7978845608028654  # sqrt(2/pi)
    return (0.5 * f * (1.0 + torch.tanh(c * (f + 0.044715 * f * f * f)))
            ).to(v.dtype)


def _ln_f32(z, scale, bias, eps):
    mean = z.mean(-1, keepdim=True)
    var = torch.square(z - mean).mean(-1, keepdim=True)
    return (z - mean) * torch.rsqrt(var + eps) * scale + bias


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def out_ln_reference(a2, w, b, res2, ln_s, ln_b, p=0.0, eps=1e-5):
    """Composed chain of fused_out_ln: (z in res2.dtype, h in a2.dtype)."""
    _unsupported(p)
    y = a2.float() @ w.float() + b.float()
    z = y + res2.float()
    h = _ln_f32(z, ln_s.float(), ln_b.float(), eps)
    return z.to(res2.dtype), h.to(a2.dtype)


def ffn_ln_reference(x2, w1, b1, w2, b2, res2, ln_s=None, ln_b=None,
                     act="gelu_tanh", norm="none", p=0.0, eps=1e-5):
    """Composed chain of fused_ffn_ln, in res2.dtype (ln_s/ln_b are
    unused with norm "none")."""
    _unsupported(p, act, norm)
    hid = gelu_tanh(x2.float() @ w1.float() + b1.float())
    y = hid @ w2.float() + b2.float()
    return (y + res2.float()).to(res2.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def out_ln_split_k(m: int, k: int, n: int) -> int:
    """K depth per split of fused_out_ln (a multiple of the kernel's k
    stage). When the output tiles alone cannot fill the card (decode:
    M = slot count) K is split so that about two blocks run per SM; the
    partial sums are added in split order by the tile's last block."""
    tiles = math.ceil(m / _ROW_TILE) * math.ceil(n / _OUT_COL_TILE)
    splits = 1 if tiles >= _SMS else math.ceil(2 * _SMS / tiles)
    splits = max(1, min(splits, k // (4 * _K_STAGE)))
    return math.ceil(math.ceil(k / splits) / _K_STAGE) * _K_STAGE


def ffn_block_i(m: int) -> int:
    """Intermediate columns per block of fused_ffn_ln: 64 while the row
    tiles are few (decode), so I/64 blocks share the weight stream;
    128 otherwise, which halves the partial sums to reduce."""
    return 64 if m <= 2 * _ROW_TILE else 128


_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(name_tensors, dev, dtype):
    for name, t in name_tensors:
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype} for the kernel, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _dtype_code(t, what):
    if t.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{what} takes float32 or bfloat16 inputs, got "
                        f"{t.dtype}")
    return _KERNEL_DTYPES[t.dtype]


def _raise_if(err, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _out_ln_kernel(a2, w, b, res2, ln_s, ln_b, eps):
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
    kc = out_ln_split_k(m, k, n)
    splits = math.ceil(k / kc)
    row_tiles = math.ceil(m / _ROW_TILE)
    col_tiles = math.ceil(n / _OUT_COL_TILE)
    z = torch.empty_like(res2)
    h = torch.empty_like(res2)
    # the LN reads z back in f32: z itself, or an f32 copy beside a bf16 z
    zf = z if code == 0 else torch.empty(
        (m, n), dtype=torch.float32, device=a2.device)
    part = torch.empty((splits, m, n) if splits > 1 else (1,),
                       dtype=torch.float32, device=a2.device)
    tickets = torch.zeros(row_tiles * col_tiles + row_tiles,
                          dtype=torch.int32, device=a2.device)
    fn = _build.function("fused_block", "fused_out_ln_launch", 11, 5,
                         (ctypes.c_float, ctypes.c_void_p))
    stream = torch.cuda.current_stream(a2.device).cuda_stream
    with torch.cuda.device(a2.device):
        err = fn(a2.data_ptr(), w.data_ptr(), b.data_ptr(), res2.data_ptr(),
                 ln_s.data_ptr(), ln_b.data_ptr(), z.data_ptr(),
                 zf.data_ptr(), h.data_ptr(), part.data_ptr(),
                 tickets.data_ptr(), m, k, n, kc, code, float(eps), stream)
    _raise_if(err, "fused_out_ln")
    _build.note_launch("fused_out_ln")
    return z, h


def _ffn_kernel(x2, w1, b1, w2, b2, res2):
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
    bi = ffn_block_i(m)
    n_i = math.ceil(i / bi)
    row_tiles = math.ceil(m / _ROW_TILE)
    chunks = math.ceil(hd / _FFN_COL_CHUNK)
    out = torch.empty_like(res2)
    part = torch.empty((n_i, m, hd), dtype=torch.float32, device=x2.device)
    tickets = torch.zeros(row_tiles * chunks, dtype=torch.int32,
                          device=x2.device)
    fn = _build.function("fused_block", "fused_ffn_ln_launch", 9, 5,
                         (ctypes.c_void_p,))
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    with torch.cuda.device(x2.device):
        err = fn(x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                 b2.data_ptr(), res2.data_ptr(), out.data_ptr(),
                 part.data_ptr(), tickets.data_ptr(), m, hd, i, bi, code,
                 stream)
    _raise_if(err, "fused_ffn_ln")
    _build.note_launch("fused_ffn_ln")
    return out


def _route(t, what):
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {t.device}")
    return True


def _grads_of(chain, saved, cots):
    """The reference's composed backward: recompute `chain` in f32 under
    autograd from the saved inputs and return each input's gradient in
    that input's dtype."""
    with torch.enable_grad():
        ins = [t.detach().float().requires_grad_() for t in saved]
        outs = chain(*ins)
        grads = torch.autograd.grad(outs, ins, [c.float() for c in cots])
    return [g.to(t.dtype) for g, t in zip(grads, saved)]


class _OutLn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a2, w, b, res2, ln_s, ln_b, eps):
        ctx.save_for_backward(a2, w, b, res2, ln_s, ln_b)
        ctx.eps = eps
        if _route(a2, "fused_out_ln"):
            return _out_ln_kernel(a2, w, b, res2, ln_s, ln_b, eps)
        return out_ln_reference(a2, w, b, res2, ln_s, ln_b, 0.0, eps)

    @staticmethod
    def backward(ctx, dz, dh):
        eps = ctx.eps
        grads = _grads_of(
            lambda *t: out_ln_reference(*t, 0.0, eps), ctx.saved_tensors,
            (dz, dh))
        return (*grads, None)


class _FfnLn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, w1, b1, w2, b2, res2):
        ctx.save_for_backward(x2, w1, b1, w2, b2, res2)
        if _route(x2, "fused_ffn_ln"):
            return _ffn_kernel(x2, w1, b1, w2, b2, res2)
        return ffn_ln_reference(x2, w1, b1, w2, b2, res2)

    @staticmethod
    def backward(ctx, dy):
        return tuple(_grads_of(ffn_ln_reference, ctx.saved_tensors, (dy,)))


def fused_out_ln(a2, w, b, res2, ln_s, ln_b, p=0.0, eps=1e-5):
    """a2 (M, Din) @ w (Din, Dout) + b + res2, then layernorm.

    Returns (z, h): z (M, Dout) is the new residual stream, h is
    LN(z) * ln_s + ln_b. CPU tensors take out_ln_reference. Differentiable
    in every tensor input (composed f32 backward)."""
    _unsupported(p)
    return _OutLn.apply(a2, w, b, res2, ln_s, ln_b, eps)


def fused_ffn_ln(x2, w1, b1, w2, b2, res2, ln_s=None, ln_b=None,
                 act="gelu_tanh", norm="none", p=0.0, eps=1e-5):
    """The FFN sub-block in one launch: res2 + act(x2 @ w1 + b1) @ w2 +
    b2. CPU tensors take ffn_ln_reference. Differentiable in x2, w1, b1,
    w2, b2 and res2 (composed f32 backward); ln_s/ln_b are unused with
    norm "none"."""
    _unsupported(p, act, norm)
    return _FfnLn.apply(x2, w1, b1, w2, b2, res2)

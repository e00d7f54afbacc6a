"""Fused dropout + residual add + layer norm, forward and backward
(counterpart of ``paddle_tpu/ops/pallas_fused_residual.py``).

  * ``fused_dropout_add_ln(x2d, res2d, scale, bias, seed, p, eps) -> y``,
    y = LN(res2d + dropout_p(x2d)) * scale + bias on (R, C) rows. A
    ``torch.autograd.Function``: the forward also keeps the pre-norm sum
    z and the row statistics; the backward kernel writes
    ``dres = dz`` and ``dx = keep ? dz / (1 - p) : 0`` with the mask
    replayed from the seed (no mask tensor exists), and dscale/dbias are
    cross-row sums in PyTorch. At p = 0, dx is dres bit for bit: the
    kernel writes dres alone and the backward returns that one tensor as
    both gradients (autograd gives each leaf its own copy).
  * ``keep_mask(seed, rows, cols, p)`` — the reference's unsalted
    counter hash (``_keep``): murmur3's finaliser over
    ``seed ^ ((row * cols + col) * 0x85ebca6b)`` in uint32 wrap-around
    arithmetic, kept where the hash >= min(int(p * 2**32), 2**32 - 1).
    One int32 seed gives the same mask bit for bit here, in the CUDA
    kernels (``csrc/dropout_hash.cuh``) and in the JAX package. The
    fused sub-blocks (``fused_block.py``) use the same mask.
  * ``dropout_add_ln_reference`` / ``dropout_add_ln_bwd_reference`` — the
    plain versions of the two kernels, which CPU tensors take.

CUDA tensors go to ``csrc/fused_residual.cu`` (float32 or bfloat16 rows,
one type per call; f32 arithmetic; float32 scale and bias) or the call
raises. Any R >= 1; 1 <= C <= 16384.

Each kernel has the layer norm's two routes, picked before the launch by
``layer_norm.ln_route`` over the pointers the call reads and writes
(``_ptrs``; a null dx at p = 0 decides nothing): "warp" (a warp owns a
row in registers; C a multiple of one 16-byte vector, C <=
``WARP_MAX_COLS``, every tensor 16-byte aligned; rows a block and
blocks from ``ln_grid``) and "row" (a block owns a row in shared memory;
everything else). Every launch counts under ``dropout_add_ln_fwd`` /
``dropout_add_ln_bwd`` and under its route, ``<name>.warp`` or
``<name>.row``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ._launch import (_check, _dtype_code, _drop_args, _raise_if, _route,
                      _sms, keep_threshold)
from .layer_norm import MAX_COLS, _affine_grads, _rows_cols, ln_grid, ln_route

__all__ = ["fused_dropout_add_ln", "keep_mask", "hash_u32", "apply_keep",
           "dropout_add_ln_reference", "dropout_add_ln_bwd_reference",
           "MAX_COLS"]

_U32 = 0xFFFFFFFF


def _mul_u32(x, c: int):
    """(x * c) mod 2**32 for uint32 lanes held in int64; the 16-bit split
    of the constant keeps every intermediate below 2**49."""
    lo = x * (c & 0xFFFF)
    hi = (x * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _U32


def hash_u32(salt, ids):
    """murmur3's finaliser over ``salt ^ (ids * 0x85ebca6b)``: uint32
    lanes in int64 tensors (or a Python int salt), every step masked to
    32 bits."""
    x = (salt & _U32) ^ _mul_u32(ids & _U32, 0x85EBCA6B)
    x = x ^ (x >> 16)
    x = _mul_u32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul_u32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def keep_mask(seed: int, rows: int, cols: int, p: float, device="cpu"):
    """(rows, cols) bool: the elements dropout keeps, by the unsalted
    hash over the element ids ``row * cols + col``."""
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(cols, dtype=torch.int64, device=device)[None, :]
    return hash_u32(int(seed), r * cols + c) >= keep_threshold(p)


def apply_keep(v, seed, p):
    """dropout_p of the 2-d f32 tensor v under keep_mask."""
    if p <= 0.0:
        return v
    keep = keep_mask(seed, v.shape[0], v.shape[1], p, v.device)
    return torch.where(keep, v / (1.0 - p), torch.zeros_like(v))


def dropout_add_ln_reference(x2d, res2d, scale, bias, seed, p, eps):
    """Plain version of the forward kernel: (y, z in x2d's dtype, mean,
    rstd (R,) f32). The layer norm runs on the unrounded f32 z."""
    z = apply_keep(x2d.float(), seed, p) + res2d.float()
    mean = z.mean(-1, keepdim=True)
    var = torch.square(z - mean).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (z - mean) * rstd * scale.float() + bias.float()
    return y.to(x2d.dtype), z.to(x2d.dtype), mean[:, 0], rstd[:, 0]


def dropout_add_ln_bwd_reference(z, scale, mean, rstd, dy, seed, p):
    """Plain version of the backward kernel: (dx, dres) in z's dtype; at
    p = 0 one tensor, dres, as both."""
    zhat = (z.float() - mean[:, None]) * rstd[:, None]
    a = dy.float() * scale.float()
    c1 = a.mean(-1, keepdim=True)
    c2 = (a * zhat).mean(-1, keepdim=True)
    dz = rstd[:, None] * (a - c1 - zhat * c2)
    dres = dz.to(z.dtype)
    if p <= 0.0:
        return dres, dres
    return apply_keep(dz, seed, p).to(z.dtype), dres


def _ptrs(*tensors):
    """The data pointers that decide a call's route: those of the
    tensors it reads and writes, a None (dx at p = 0) left out."""
    return [t.data_ptr() for t in tensors if t is not None]


def _fwd_kernel(x2d, res2d, scale, bias, seed, p, eps):
    r, c = _rows_cols(x2d, "fused_dropout_add_ln")
    code = _dtype_code(x2d, "fused_dropout_add_ln")
    _check([("x2d", x2d), ("res2d", res2d)], x2d.device, x2d.dtype)
    _check([("scale", scale), ("bias", bias)], x2d.device, torch.float32)
    if res2d.shape != x2d.shape or scale.shape != (c,) \
            or bias.shape != (c,):
        raise ValueError(f"fused_dropout_add_ln shapes: x "
                         f"{tuple(x2d.shape)}, res {tuple(res2d.shape)}, "
                         f"scale {tuple(scale.shape)}")
    seed, on, thr, keep_div = _drop_args(seed, p)
    y = torch.empty_like(x2d)
    z = torch.empty_like(x2d)
    mean = torch.empty((r,), dtype=torch.float32, device=x2d.device)
    rstd = torch.empty_like(mean)
    route = ln_route(c, x2d.dtype, _ptrs(x2d, res2d, scale, bias, y, z))
    args = [x2d.data_ptr(), res2d.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), y.data_ptr(), z.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), r, c, code, seed, on, thr, keep_div,
            float(eps)]
    tail = (ctypes.c_uint, ctypes.c_float, ctypes.c_float)
    if route == "warp":
        fn = _build.function(
            "fused_residual", "dropout_add_ln_fwd_warp_launch", 8, 5,
            tail + (ctypes.c_int, ctypes.c_int, ctypes.c_void_p))
        args += ln_grid(r, _sms(x2d.device.index))
    else:
        fn = _build.function("fused_residual", "dropout_add_ln_fwd_launch",
                             8, 5, tail + (ctypes.c_void_p,))
    stream = torch.cuda.current_stream(x2d.device).cuda_stream
    with torch.cuda.device(x2d.device):
        err = fn(*args, stream)
    _raise_if(err, f"dropout_add_ln_fwd ({route} route)")
    _build.note_launch("dropout_add_ln_fwd")
    _build.note_launch(f"dropout_add_ln_fwd.{route}")
    return y, z, mean, rstd


def _bwd_kernel(z, scale, mean, rstd, dy, seed, p):
    """(dx, dres) from the kernel; at p = 0 one tensor, dres, as both."""
    r, c = _rows_cols(z, "fused_dropout_add_ln backward")
    code = _dtype_code(z, "fused_dropout_add_ln")
    _check([("z", z), ("dy", dy)], z.device, z.dtype)
    _check([("scale", scale), ("mean", mean), ("rstd", rstd)], z.device,
           torch.float32)
    if dy.shape != z.shape or scale.shape != (c,) or mean.shape != (r,) \
            or rstd.shape != (r,):
        raise ValueError(f"fused_dropout_add_ln backward shapes: z "
                         f"{tuple(z.shape)}, dy {tuple(dy.shape)}, scale "
                         f"{tuple(scale.shape)}, mean {tuple(mean.shape)}")
    seed, on, thr, keep_div = _drop_args(seed, p)
    dres = torch.empty_like(z)
    # p = 0: dx = dz / 1 is dres bit for bit; the kernel writes dres alone
    dx = torch.empty_like(z) if on else None
    route = ln_route(c, z.dtype, _ptrs(z, scale, dy, dres, dx))
    args = [z.data_ptr(), scale.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), dy.data_ptr(),
            None if dx is None else dx.data_ptr(), dres.data_ptr(), r, c,
            code, seed, on, thr, keep_div]
    if route == "warp":
        fn = _build.function(
            "fused_residual", "dropout_add_ln_bwd_warp_launch", 7, 5,
            (ctypes.c_uint, ctypes.c_float, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p))
        args += ln_grid(r, _sms(z.device.index))
    else:
        fn = _build.function(
            "fused_residual", "dropout_add_ln_bwd_launch", 7, 5,
            (ctypes.c_uint, ctypes.c_float, ctypes.c_void_p))
    stream = torch.cuda.current_stream(z.device).cuda_stream
    with torch.cuda.device(z.device):
        err = fn(*args, stream)
    _raise_if(err, f"dropout_add_ln_bwd ({route} route)")
    _build.note_launch("dropout_add_ln_bwd")
    _build.note_launch(f"dropout_add_ln_bwd.{route}")
    return (dres if dx is None else dx), dres


class _DropoutAddLn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, res2d, scale, bias, seed, p, eps):
        if _route(x2d, "fused_dropout_add_ln"):
            y, z, mean, rstd = _fwd_kernel(
                x2d, res2d, scale.float().contiguous(),
                bias.float().contiguous(), seed, p, eps)
        else:
            y, z, mean, rstd = dropout_add_ln_reference(
                x2d, res2d, scale, bias, seed, p, eps)
        ctx.save_for_backward(z, scale, mean, rstd)
        ctx.seed, ctx.p, ctx.bias_dtype = seed, p, bias.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        z, scale, mean, rstd = ctx.saved_tensors
        dy = dy.to(z.dtype).contiguous()
        if _route(z, "fused_dropout_add_ln"):
            dx, dres = _bwd_kernel(z, scale.float().contiguous(), mean,
                                   rstd, dy, ctx.seed, ctx.p)
        else:
            dx, dres = dropout_add_ln_bwd_reference(
                z, scale, mean, rstd, dy, ctx.seed, ctx.p)
        dscale, dbias = _affine_grads(dy, z, mean, rstd, scale)
        # at p = 0 dx is dres itself: one gradient for both inputs, as
        # the add's own backward hands them
        return (dx, dres, dscale, dbias.to(ctx.bias_dtype), None, None,
                None)


def fused_dropout_add_ln(x2d, res2d, scale, bias, seed=0, p=0.0, eps=1e-5):
    """y = LN(res2d + dropout_p(x2d)) * scale + bias on (R, C) rows of
    one dtype; seed an int32 (no gradient), p and eps floats.
    Differentiable in x2d (mask replayed), res2d, scale and bias. CPU
    tensors take the plain versions; CUDA tensors the kernels."""
    _rows_cols(x2d, "fused_dropout_add_ln")
    if res2d.dtype != x2d.dtype:
        raise TypeError(f"fused_dropout_add_ln: x is {x2d.dtype}, res "
                        f"{res2d.dtype}; one type per call")
    return _DropoutAddLn.apply(x2d.contiguous(), res2d.contiguous(), scale,
                               bias, int(seed), float(p), float(eps))

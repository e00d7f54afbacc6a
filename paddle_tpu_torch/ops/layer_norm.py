"""Fused row layer norm, forward and backward (counterpart of
``paddle_tpu/ops/pallas_layer_norm.py``).

  * ``fused_layer_norm(x2d, scale, bias, eps) -> (y, mean, rstd)`` on
    x2d (R, C), scale/bias (C,): y in x2d's dtype, mean and rstd (R,)
    float32 and non-differentiable, as the reference's. A
    ``torch.autograd.Function``: the backward computes dx with the second
    kernel, and dscale/dbias as cross-row sums in PyTorch (the reference
    leaves them to jnp).
  * ``layer_norm_reference`` and ``layer_norm_bwd_dx_reference`` — the
    plain versions of the two kernels, which CPU tensors take.

CUDA tensors go to ``csrc/layer_norm.cu`` (float32 or bfloat16 rows, f32
arithmetic and statistics, float32 scale and bias) or the call raises.
Any R >= 1; 1 <= C <= 16384. The statistics are two-pass (mean, then the
mean of squared differences), so a zero-variance row gives
rstd = rsqrt(eps) exactly.

Each kernel has two routes, picked before the launch by the pure
``ln_route(C, dtype, ptrs)``: "warp" (a warp owns a row in registers;
C a multiple of one 16-byte vector, C <= ``WARP_MAX_COLS``, every
tensor 16-byte aligned), with ``ln_grid(R, sms)`` rows a block and
blocks, and "row" (a block owns a row in shared memory; everything
else). Every launch counts under ``layer_norm_fwd`` /
``layer_norm_bwd_dx`` and under its route, ``<name>.warp`` or
``<name>.row``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from ._launch import _check, _dtype_code, _raise_if, _route, _sms

__all__ = ["fused_layer_norm", "layer_norm_reference",
           "layer_norm_bwd_dx_reference", "ln_route", "ln_grid", "MAX_COLS",
           "WARP_MAX_COLS"]

MAX_COLS = 16384
# the warp route's register cap: 32 elements a lane (csrc/row_norm.cuh
# kLaneElems), so C <= 32 * 32
WARP_MAX_COLS = 1024
_WARPS = 8              # rows a block of the warp route, at most
_BLOCKS_PER_SM = 2      # resident blocks an SM the warp route's grid fills


def ln_route(c: int, dtype, ptrs) -> str:
    """The route of a layer-norm kernel call on rows of `c` columns of
    `dtype` whose tensors sit at the addresses `ptrs` (data_ptr()):
    "warp" when a row is whole 16-byte vectors (c a multiple of 4 in
    float32, of 8 in bfloat16), c <= WARP_MAX_COLS and every address is
    16-byte aligned; "row" otherwise. Pure: the wrapper asks it before
    the launch, nothing is tried and caught."""
    if dtype not in (torch.float32, torch.bfloat16):
        return "row"
    vec = 4 if dtype == torch.float32 else 8
    if c % vec or c > WARP_MAX_COLS or any(p % 16 for p in ptrs):
        return "row"
    return "warp"


def ln_grid(r: int, sms: int) -> tuple[int, int]:
    """(rows a block, blocks) of the warp route for r rows on a card of
    `sms` multiprocessors: r // sms rows a block, between 1 and _WARPS,
    so that a short call spreads over every SM; at most _BLOCKS_PER_SM
    blocks an SM, each warp walking rows beyond that. At 132 SMs: R = 304
    takes 2 rows a block (152 blocks), R = 2048 takes 8 (256 blocks, one
    wave)."""
    rows = max(1, min(_WARPS, r // sms))
    return rows, min(math.ceil(r / rows), _BLOCKS_PER_SM * sms)


def layer_norm_reference(x2d, scale, bias, eps):
    """Plain version of the forward kernel: (y in x2d's dtype, mean (R,)
    f32, rstd (R,) f32)."""
    xf = x2d.float()
    mean = xf.mean(-1, keepdim=True)
    var = torch.square(xf - mean).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (xf - mean) * rstd * scale.float() + bias.float()
    return y.to(x2d.dtype), mean[:, 0], rstd[:, 0]


def layer_norm_bwd_dx_reference(x2d, scale, mean, rstd, dy):
    """Plain version of the backward kernel: dx in x2d's dtype."""
    xhat = (x2d.float() - mean[:, None]) * rstd[:, None]
    a = dy.float() * scale.float()
    c1 = a.mean(-1, keepdim=True)
    c2 = (a * xhat).mean(-1, keepdim=True)
    return (rstd[:, None] * (a - c1 - xhat * c2)).to(x2d.dtype)


def _rows_cols(x2d, what):
    if x2d.dim() != 2:
        raise ValueError(f"{what} takes a 2-d (R, C) input, got "
                         f"{tuple(x2d.shape)}")
    r, c = x2d.shape
    if r < 1 or not 1 <= c <= MAX_COLS:
        raise ValueError(f"{what}: R >= 1 and 1 <= C <= {MAX_COLS}, got "
                         f"{tuple(x2d.shape)}")
    return r, c


def _fwd_kernel(x2d, scale, bias, eps):
    r, c = _rows_cols(x2d, "fused_layer_norm")
    code = _dtype_code(x2d, "fused_layer_norm")
    _check([("x2d", x2d)], x2d.device, x2d.dtype)
    _check([("scale", scale), ("bias", bias)], x2d.device, torch.float32)
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"fused_layer_norm shapes: x {tuple(x2d.shape)}, "
                         f"scale {tuple(scale.shape)}, bias "
                         f"{tuple(bias.shape)}")
    y = torch.empty_like(x2d)
    mean = torch.empty((r,), dtype=torch.float32, device=x2d.device)
    rstd = torch.empty_like(mean)
    route = ln_route(c, x2d.dtype,
                     [t.data_ptr() for t in (x2d, scale, bias, y)])
    args = [x2d.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), r, c, code, float(eps)]
    if route == "warp":
        fn = _build.function("layer_norm", "layer_norm_fwd_warp_launch", 6,
                             3, (ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p))
        args += ln_grid(r, _sms(x2d.device.index))
    else:
        fn = _build.function("layer_norm", "layer_norm_fwd_launch", 6, 3,
                             (ctypes.c_float, ctypes.c_void_p))
    stream = torch.cuda.current_stream(x2d.device).cuda_stream
    with torch.cuda.device(x2d.device):
        err = fn(*args, stream)
    _raise_if(err, f"layer_norm_fwd ({route} route)")
    _build.note_launch("layer_norm_fwd")
    _build.note_launch(f"layer_norm_fwd.{route}")
    return y, mean, rstd


def _bwd_dx_kernel(x2d, scale, mean, rstd, dy):
    r, c = _rows_cols(x2d, "fused_layer_norm backward")
    code = _dtype_code(x2d, "fused_layer_norm")
    _check([("x2d", x2d), ("dy", dy)], x2d.device, x2d.dtype)
    _check([("scale", scale), ("mean", mean), ("rstd", rstd)], x2d.device,
           torch.float32)
    if dy.shape != x2d.shape or scale.shape != (c,) or mean.shape != (r,) \
            or rstd.shape != (r,):
        raise ValueError(f"fused_layer_norm backward shapes: x "
                         f"{tuple(x2d.shape)}, dy {tuple(dy.shape)}, scale "
                         f"{tuple(scale.shape)}, mean {tuple(mean.shape)}")
    dx = torch.empty_like(x2d)
    route = ln_route(c, x2d.dtype,
                     [t.data_ptr() for t in (x2d, scale, dy, dx)])
    args = [x2d.data_ptr(), scale.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), dy.data_ptr(), dx.data_ptr(), r, c, code]
    if route == "warp":
        fn = _build.function("layer_norm", "layer_norm_bwd_dx_warp_launch",
                             6, 5, (ctypes.c_void_p,))
        args += ln_grid(r, _sms(x2d.device.index))
    else:
        fn = _build.function("layer_norm", "layer_norm_bwd_dx_launch", 6, 3,
                             (ctypes.c_void_p,))
    stream = torch.cuda.current_stream(x2d.device).cuda_stream
    with torch.cuda.device(x2d.device):
        err = fn(*args, stream)
    _raise_if(err, f"layer_norm_bwd_dx ({route} route)")
    _build.note_launch("layer_norm_bwd_dx")
    _build.note_launch(f"layer_norm_bwd_dx.{route}")
    return dx


def _affine_grads(dy, v2d, mean, rstd, scale):
    """(dscale, dbias) in scale's dtype: sums over rows of dy * vhat and
    of dy, in f32 (pallas_layer_norm.py:_ln_bwd)."""
    dyf = dy.float()
    vhat = (v2d.float() - mean[:, None]) * rstd[:, None]
    return ((dyf * vhat).sum(0).to(scale.dtype),
            dyf.sum(0).to(scale.dtype))


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, scale, bias, eps):
        if _route(x2d, "fused_layer_norm"):
            y, mean, rstd = _fwd_kernel(x2d, scale.float().contiguous(),
                                        bias.float().contiguous(), eps)
        else:
            y, mean, rstd = layer_norm_reference(x2d, scale, bias, eps)
        ctx.save_for_backward(x2d, scale, mean, rstd)
        ctx.bias_dtype = bias.dtype
        ctx.mark_non_differentiable(mean, rstd)
        return y, mean, rstd

    @staticmethod
    def backward(ctx, dy, _dmean, _drstd):
        x2d, scale, mean, rstd = ctx.saved_tensors
        dy = dy.to(x2d.dtype).contiguous()
        if _route(x2d, "fused_layer_norm"):
            dx = _bwd_dx_kernel(x2d, scale.float().contiguous(), mean, rstd,
                                dy)
        else:
            dx = layer_norm_bwd_dx_reference(x2d, scale, mean, rstd, dy)
        dscale, dbias = _affine_grads(dy, x2d, mean, rstd, scale)
        return dx, dscale, dbias.to(ctx.bias_dtype), None


def fused_layer_norm(x2d, scale, bias, eps=1e-5):
    """x2d (R, C) contiguous, scale/bias (C,) -> (y, mean, rstd);
    differentiable in x2d, scale and bias through y. CPU tensors take the
    plain versions; CUDA tensors the kernels."""
    _rows_cols(x2d, "fused_layer_norm")
    return _LayerNorm.apply(x2d.contiguous(), scale, bias, float(eps))

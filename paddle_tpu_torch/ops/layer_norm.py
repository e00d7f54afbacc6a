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
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ._launch import _check, _dtype_code, _raise_if, _route

__all__ = ["fused_layer_norm", "layer_norm_reference",
           "layer_norm_bwd_dx_reference", "MAX_COLS"]

MAX_COLS = 16384


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
    fn = _build.function("layer_norm", "layer_norm_fwd_launch", 6, 3,
                         (ctypes.c_float, ctypes.c_void_p))
    stream = torch.cuda.current_stream(x2d.device).cuda_stream
    with torch.cuda.device(x2d.device):
        err = fn(x2d.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                 y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), r, c, code,
                 float(eps), stream)
    _raise_if(err, "layer_norm_fwd")
    _build.note_launch("layer_norm_fwd")
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
    fn = _build.function("layer_norm", "layer_norm_bwd_dx_launch", 6, 3,
                         (ctypes.c_void_p,))
    stream = torch.cuda.current_stream(x2d.device).cuda_stream
    with torch.cuda.device(x2d.device):
        err = fn(x2d.data_ptr(), scale.data_ptr(), mean.data_ptr(),
                 rstd.data_ptr(), dy.data_ptr(), dx.data_ptr(), r, c, code,
                 stream)
    _raise_if(err, "layer_norm_bwd_dx")
    _build.note_launch("layer_norm_bwd_dx")
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

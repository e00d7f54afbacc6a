"""Flash (blockwise) attention, forward and backward (counterpart of
``paddle_tpu/ops/pallas_attention.py``, with ``sdpa_reference`` from
``paddle_tpu/ops/flash_attention.py``).

  * ``flash_attention(q, k, v, mask=None, scale=None, causal=False,
    dropout_p=0.0, dropout_seed=0)`` — the reference's signature, on
    (B, H, S, D). A ``torch.autograd.Function``: the forward saves q, k,
    v, o and the row logsumexp; the backward computes
    ``delta = rowsum(dO * O)`` in PyTorch (the reference does it in jnp)
    and runs the dQ and dK/dV kernels.
  * ``flash_fwd_reference``, ``bwd_dq_reference`` and
    ``bwd_dkv_reference`` (both behind ``flash_bwd_reference``) — the
    plain versions of the three kernels, which CPU tensors take; the
    backward ones recompute P from the saved logsumexp as the kernels
    do.
  * ``sdpa_reference`` — the composed oracle.

CUDA tensors go to ``csrc/flash_attention.cu`` (float32 or bfloat16,
f32 arithmetic) or the call raises. The domain is the reference's
(``can_use_flash``): D % 8 == 0, D <= 256, S and T multiples of 64 (the
reference's smallest block); outside it the reference itself fails, and
the port raises ValueError. Padding masks and in-kernel dropout come
with the BERT slice and raise NotImplementedError until then.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .fused_block import _check, _dtype_code, _raise_if, _route

__all__ = ["flash_attention", "can_use_flash", "sdpa_reference",
           "flash_fwd_reference", "flash_bwd_reference", "bwd_dq_reference",
           "bwd_dkv_reference", "bwd_delta"]

_MIN_BLOCK = 64


def sdpa_reference(q, k, v, mask=None, scale=None, causal=False):
    """q, k, v: (B, H, S, D); mask additive, broadcastable to
    (B, H, S, T). Softmax in f32, output in v's dtype."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * scale
    if causal:
        s, t = logits.shape[-2], logits.shape[-1]
        cm = torch.ones((s, t), dtype=torch.bool, device=q.device).tril()
        logits = torch.where(cm, logits, torch.full_like(logits, -1e30))
    if mask is not None:
        logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", probs.to(v.dtype), v)


def can_use_flash(q, k, v, mask=None, dropout_p=0.0) -> bool:
    """Whether the port's flash kernels take this call: (B, H, S, D)
    inputs with D % 8 == 0, D <= 256, S and T multiples of 64, no mask
    and no dropout (those come with the BERT slice)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        return False
    s, d = q.shape[2], q.shape[3]
    t = k.shape[2]
    if s % _MIN_BLOCK or t % _MIN_BLOCK or d % 8 or d > 256:
        return False
    return mask is None and dropout_p == 0.0


def _causal_mask(s, t, device):
    return torch.ones((s, t), dtype=torch.bool, device=device).tril()


def flash_fwd_reference(q3, k3, v3, scale, causal):
    """Plain version of the forward kernel on (BH, S, D): (o in q's
    dtype, lse (BH, S) f32)."""
    s = torch.matmul(q3.float(), k3.float().transpose(1, 2)) * scale
    if causal:
        s = s.masked_fill(~_causal_mask(s.shape[1], s.shape[2], s.device),
                          float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p, v3.float()) / l
    return o.to(q3.dtype), (m + torch.log(l)).squeeze(-1)


def _bwd_p_ds(q3, k3, v3, o, lse, do, scale, causal):
    """(qf, kf, dof, p, ds) in f32: P recomputed from lse (the
    reference's _recompute_p), delta = rowsum(dO * O) and
    ds = P * (dO V^T - delta) * scale."""
    qf, kf, vf, dof = q3.float(), k3.float(), v3.float(), do.float()
    s = torch.matmul(qf, kf.transpose(1, 2)) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        p = torch.where(_causal_mask(s.shape[1], s.shape[2], s.device), p,
                        torch.zeros_like(p))
    delta = (dof * o.float()).sum(-1, keepdim=True)
    ds = p * (torch.matmul(dof, vf.transpose(1, 2)) - delta) * scale
    return qf, kf, dof, p, ds


def bwd_dq_reference(q3, k3, v3, o, lse, do, scale, causal):
    """Plain version of the dQ kernel: dq = ds k, in q's dtype."""
    _, kf, _, _, ds = _bwd_p_ds(q3, k3, v3, o, lse, do, scale, causal)
    return torch.matmul(ds, kf).to(q3.dtype)


def bwd_dkv_reference(q3, k3, v3, o, lse, do, scale, causal):
    """Plain version of the dK/dV kernel: (dk = ds^T q, dv = p^T dO) in
    k's and v's dtypes."""
    qf, _, dof, p, ds = _bwd_p_ds(q3, k3, v3, o, lse, do, scale, causal)
    dk = torch.matmul(ds.transpose(1, 2), qf)
    dv = torch.matmul(p.transpose(1, 2), dof)
    return dk.to(k3.dtype), dv.to(v3.dtype)


def flash_bwd_reference(q3, k3, v3, o, lse, do, scale, causal):
    """Plain version of the two backward kernels: (dq, dk, dv)."""
    return (bwd_dq_reference(q3, k3, v3, o, lse, do, scale, causal),
            *bwd_dkv_reference(q3, k3, v3, o, lse, do, scale, causal))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _dims(q3, k3, v3):
    bh, s, d = q3.shape
    t = k3.shape[1]
    if tuple(k3.shape) != (bh, t, d) or v3.shape != k3.shape:
        raise ValueError(f"flash shapes: q {tuple(q3.shape)}, k "
                         f"{tuple(k3.shape)}, v {tuple(v3.shape)}")
    _check([("q", q3), ("k", k3), ("v", v3)], q3.device, q3.dtype)
    return bh, s, t, d, _dtype_code(q3, "flash_attention")


def _fwd_kernel(q3, k3, v3, scale, causal):
    bh, s, t, d, code = _dims(q3, k3, v3)
    o = torch.empty_like(q3)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q3.device)
    fn = _build.function("flash_attention", "flash_fwd_launch", 5, 6,
                         (ctypes.c_float, ctypes.c_void_p))
    stream = torch.cuda.current_stream(q3.device).cuda_stream
    with torch.cuda.device(q3.device):
        err = fn(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), bh, s, t, d, code, int(causal),
                 float(scale), stream)
    _raise_if(err, "flash_fwd")
    _build.note_launch("flash_fwd")
    return o, lse


def _bwd_common(q3, k3, v3, do, lse, delta):
    bh, s, t, d, code = _dims(q3, k3, v3)
    if do.shape != q3.shape or tuple(lse.shape) != (bh, s) \
            or delta.shape != lse.shape:
        raise ValueError(f"flash backward shapes: q {tuple(q3.shape)}, do "
                         f"{tuple(do.shape)}, lse {tuple(lse.shape)}, delta "
                         f"{tuple(delta.shape)}")
    _check([("do", do)], q3.device, q3.dtype)
    _check([("lse", lse), ("delta", delta)], q3.device, torch.float32)
    return bh, s, t, d, code


def _dq_kernel(q3, k3, v3, do, lse, delta, scale, causal):
    bh, s, t, d, code = _bwd_common(q3, k3, v3, do, lse, delta)
    dq = torch.empty_like(q3)
    fn = _build.function("flash_attention", "flash_bwd_dq_launch", 7, 6,
                         (ctypes.c_float, ctypes.c_void_p))
    stream = torch.cuda.current_stream(q3.device).cuda_stream
    with torch.cuda.device(q3.device):
        err = fn(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, s, t,
                 d, code, int(causal), float(scale), stream)
    _raise_if(err, "flash_bwd_dq")
    _build.note_launch("flash_bwd_dq")
    return dq


def _dkv_kernel(q3, k3, v3, do, lse, delta, scale, causal):
    bh, s, t, d, code = _bwd_common(q3, k3, v3, do, lse, delta)
    dk = torch.empty_like(k3)
    dv = torch.empty_like(v3)
    fn = _build.function("flash_attention", "flash_bwd_dkv_launch", 8, 6,
                         (ctypes.c_float, ctypes.c_void_p))
    stream = torch.cuda.current_stream(q3.device).cuda_stream
    with torch.cuda.device(q3.device):
        err = fn(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), bh, s, t, d, code, int(causal),
                 float(scale), stream)
    _raise_if(err, "flash_bwd_dkv")
    _build.note_launch("flash_bwd_dkv")
    return dk, dv


def bwd_delta(o, do):
    """delta = rowsum(dO * O) in f32, (BH, S): computed in PyTorch, as
    the reference computes it in jnp."""
    return (do.float() * o.float()).sum(-1)


def _bwd_kernels(q3, k3, v3, o, lse, do, scale, causal):
    delta = bwd_delta(o, do)
    dq = _dq_kernel(q3, k3, v3, do, lse, delta, scale, causal)
    dk, dv = _dkv_kernel(q3, k3, v3, do, lse, delta, scale, causal)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q3, k3, v3, scale, causal):
        if _route(q3, "flash_attention"):
            o, lse = _fwd_kernel(q3, k3, v3, scale, causal)
        else:
            o, lse = flash_fwd_reference(q3, k3, v3, scale, causal)
        ctx.save_for_backward(q3, k3, v3, o, lse)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q3, k3, v3, o, lse = ctx.saved_tensors
        do = do.contiguous()
        if _route(q3, "flash_attention"):
            grads = _bwd_kernels(q3, k3, v3, o, lse, do, ctx.scale,
                                 ctx.causal)
        else:
            grads = flash_bwd_reference(q3, k3, v3, o, lse, do, ctx.scale,
                                        ctx.causal)
        return (*grads, None, None)


def flash_attention(q, k, v, mask=None, scale=None, causal=False,
                    dropout_p=0.0, dropout_seed=0):
    """q, k, v: (B, H, S|T, D) -> (B, H, S, D), differentiable in q, k,
    v. CPU tensors take the plain versions; CUDA tensors the kernels."""
    if mask is not None:
        raise NotImplementedError(
            "flash_attention with a padding mask comes with the BERT slice "
            "of the port")
    if dropout_p > 0.0:
        raise NotImplementedError(
            "flash_attention with dropout (p > 0) comes with the BERT slice "
            "of the port")
    if not can_use_flash(q, k, v):
        raise ValueError(
            f"flash_attention takes (B, H, S, D) with D % 8 == 0, D <= 256 "
            f"and S, T multiples of {_MIN_BLOCK}; got q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}")
    b, h, s, d = q.shape
    t = k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    q3 = q.reshape(b * h, s, d).contiguous()
    k3 = k.reshape(b * h, t, d).contiguous()
    v3 = v.reshape(b * h, t, d).contiguous()
    o = _Flash.apply(q3, k3, v3, float(scale), bool(causal))
    return o.reshape(b, h, s, d)

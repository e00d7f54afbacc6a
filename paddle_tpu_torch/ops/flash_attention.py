"""Flash (blockwise) attention, forward and backward (counterpart of
``paddle_tpu/ops/pallas_attention.py``, with ``sdpa_reference`` from
``paddle_tpu/ops/flash_attention.py``).

  * ``flash_attention(q, k, v, mask=None, scale=None, causal=False,
    dropout_p=0.0, dropout_seed=0)`` — the reference's signature, on
    (B, H, S, D). A ``torch.autograd.Function``: the forward saves q, k,
    v, o and the row logsumexp; the backward computes
    ``delta = rowsum(dO * O)`` in PyTorch (the reference does it in jnp)
    and runs the dQ and dK/dV kernels. ``mask`` is the additive padding
    mask (B, 1, 1, T), added to the scaled scores (no gradient).
    Dropout acts on the probabilities AFTER the row sum: the logsumexp
    is dropout-free and only the product with V sees the mask, which
    the backward replays from ``dropout_seed``.
  * ``scaled_dot_product_attention(query, key, value, attn_mask,
    dropout_p, is_causal, training, seed)`` — the entry the layers call
    (``paddle_tpu/ops/flash_attention.py``): the flash kernels where
    ``can_use_flash`` admits the call, the composed ``sdpa_reference``
    otherwise (other mask shapes, unaligned lengths), both with the same
    dropout mask from the int32 ``seed`` handed in.
  * ``keep_mask_salted(seed, bh, s, t, p)`` — the reference's salted
    counter hash (``_keep_mask``): salt ``bh * 0x9e3779b9 + seed``,
    counter ``row * T + col``, uint32 wrap-around; the same bits in the
    kernels (``csrc/dropout_hash.cuh``) and in the JAX package.
  * ``flash_fwd_reference``, ``bwd_dq_reference`` and
    ``bwd_dkv_reference`` (both behind ``flash_bwd_reference``) — the
    plain versions of the three kernels, which CPU tensors take; the
    backward ones recompute P from the saved logsumexp as the kernels
    do.
  * ``sdpa_reference`` — the composed oracle.

The probabilities, the dropped probabilities and dS are rounded to the
input type before their products, where the reference's kernels round
them; P in the forward against the running row max at the reference's
key blocks (``ref_block``, which follows the reference's
``PADDLE_TPU_FLASH_BLOCK_K`` override). In float32 the rounding is the
identity. The kernels round at key blocks of 64, 128, 256 or 512; a
call whose reference block is another width raises on the card before
the launch.

CUDA tensors go to ``csrc/flash_attention.cu`` or the call raises, on
one of two routes chosen before the launch (``flash_tc_route``): bf16
at head dim 64 or 128 with 16-byte aligned operands to the tensor-core
kernels (``wgmma`` fed by TMA), everything else to the SIMT kernels
(f32 arithmetic on the CUDA cores). Each launch counts under its op
(``flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv``) and under
``<op>.tc`` or ``<op>.simt``. The domain is the reference's
(``can_use_flash``): D % 8 == 0, D <= 256, S and T multiples of 64 (the
reference's smallest block); outside it the reference itself fails, and
the port raises ValueError.
"""
from __future__ import annotations

import ctypes
import math
import os

import torch

from . import _build
from .fused_residual import hash_u32
from ._launch import (_check, _dtype_code, _drop_args, _raise_if, _route,
                      keep_threshold)

__all__ = ["flash_attention", "scaled_dot_product_attention",
           "keep_mask_salted", "can_use_flash", "sdpa_reference",
           "flash_fwd_reference", "flash_bwd_reference", "bwd_dq_reference",
           "bwd_dkv_reference", "bwd_delta", "flash_tc_route", "ref_block"]

_MIN_BLOCK = 64
# the key blocks both kernel routes round at (flash_attention.cu valid())
_KERNEL_BLOCKS = (64, 128, 256, 512)


def keep_mask_salted(seed: int, bh: int, s: int, t: int, p: float,
                     device="cpu"):
    """(bh, s, t) bool: the probabilities dropout keeps, by the salted
    hash over the element ids ``row * t + col`` of each (batch, head)."""
    i = torch.arange(bh, dtype=torch.int64, device=device)[:, None, None]
    r = torch.arange(s, dtype=torch.int64, device=device)[None, :, None]
    c = torch.arange(t, dtype=torch.int64, device=device)[None, None, :]
    salt = i * 0x9E3779B9 + (int(seed) & 0xFFFFFFFF)
    return hash_u32(salt, r * t + c) >= keep_threshold(p)


def _drop_probs(p3, seed, dropout_p):
    """dropout on (BH, S, T) f32 probabilities under keep_mask_salted."""
    if dropout_p <= 0.0:
        return p3
    keep = keep_mask_salted(seed, *p3.shape, dropout_p, p3.device)
    return torch.where(keep, p3 / (1.0 - dropout_p), torch.zeros_like(p3))


def sdpa_reference(q, k, v, mask=None, scale=None, causal=False,
                   dropout_p=0.0, seed=0):
    """q, k, v: (B, H, S, D); mask additive, broadcastable to
    (B, H, S, T). Softmax in f32, output in v's dtype. Dropout on the
    probabilities with the flash kernels' mask (the reference draws this
    path's mask from jax.random, which cannot be replayed here)."""
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
    b, h, s, t = probs.shape
    probs = _drop_probs(probs.reshape(b * h, s, t), seed,
                        dropout_p).reshape(b, h, s, t)
    return torch.einsum("bhst,bhtd->bhsd", probs.to(v.dtype), v)


def _is_padding_mask(mask, b, t) -> bool:
    return mask.dim() == 4 and tuple(mask.shape) == (b, 1, 1, t)


def can_use_flash(q, k, v, mask=None, dropout_p=0.0) -> bool:
    """Whether the port's flash kernels take this call: (B, H, S, D)
    inputs with D % 8 == 0, D <= 256, S and T multiples of 64, and no
    mask or a padding mask (B, 1, 1, T); any dropout_p."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        return False
    s, d = q.shape[2], q.shape[3]
    t = k.shape[2]
    if s % _MIN_BLOCK or t % _MIN_BLOCK or d % 8 or d > 256:
        return False
    return mask is None or _is_padding_mask(mask, q.shape[0], t)


def _causal_mask(s, t, device):
    return torch.ones((s, t), dtype=torch.bool, device=device).tril()


def _scores(q3, k3, scale, causal, mask2):
    """Scaled, masked scores (BH, S, T) in f32; mask2 (B, T) additive."""
    s = torch.matmul(q3.float(), k3.float().transpose(1, 2)) * scale
    if mask2 is not None:
        heads = s.shape[0] // mask2.shape[0]
        s = s + mask2.float().repeat_interleave(heads, 0)[:, None, :]
    if causal:
        s = s.masked_fill(~_causal_mask(s.shape[1], s.shape[2], s.device),
                          float("-inf"))
    return s


def ref_block(t: int) -> int:
    """The reference's key block for T keys (its ``_auto_block``):
    ``PADDLE_TPU_FLASH_BLOCK_K`` when it is set and divides T, else the
    largest of 512, 256, 128 and 64 dividing T. The forward rounds P
    against the running row max at these blocks' boundaries."""
    env = os.environ.get("PADDLE_TPU_FLASH_BLOCK_K")
    if env and t % int(env) == 0:
        return int(env)
    for b in (512, 256, 128, 64):
        if t % b == 0:
            return b
    raise ValueError(f"flash: T = {t} is not a multiple of {_MIN_BLOCK}")


def flash_fwd_reference(q3, k3, v3, scale, causal, mask2=None, seed=0,
                        dropout_p=0.0):
    """Plain version of the forward kernel on (BH, S, D): (o in q's
    dtype, lse (BH, S) f32). As the reference walks its key blocks, the
    probabilities of block b are exp(s - m_b), m_b the running row max
    after block b; the dropped ones are rounded to q's dtype before the
    product with V, and the accumulator is rescaled by exp(m_b - m) at
    the end (the reference rescales it block by block). The row sum and
    lse are of the unrounded, undropped probabilities."""
    s = _scores(q3, k3, scale, causal, mask2)
    bh, n, t = s.shape
    rb = ref_block(t)
    sb = s.reshape(bh, n, t // rb, rb)
    mb = torch.cummax(sb.amax(-1), -1).values          # (BH, S, blocks)
    # a row masked so far keeps m = -inf; exp against 0 keeps it NaN-free
    mb = torch.where(mb == float("-inf"), torch.zeros_like(mb), mb)
    m = mb[..., -1:]
    pb = torch.exp(sb - mb[..., None])
    carry = torch.exp(mb - m)                          # exp(m_b - m)
    l = (pb.sum(-1) * carry).sum(-1, keepdim=True)
    pd = _drop_probs(pb.reshape(bh, n, t), seed, dropout_p)
    pd = pd.to(q3.dtype).float().reshape(bh, n, t // rb, rb)
    vb = v3.float().reshape(bh, t // rb, rb, -1)
    o = (torch.einsum("hsbk,hbkd->hsbd", pd, vb) * carry[..., None]).sum(-2)
    l = torch.where(l == 0, torch.ones_like(l), l)
    return (o / l).to(q3.dtype), (m + torch.log(l)).squeeze(-1)


def _bwd_p_ds(q3, k3, v3, o, lse, do, scale, causal, mask2=None, seed=0,
              dropout_p=0.0):
    """(qf, kf, dof, pd, ds) in f32: P recomputed from lse (the
    reference's _recompute_p), pd its dropped form rounded to dO's dtype,
    delta = rowsum(dO * O) and ds = P * (dropped(dO V^T) - delta) * scale
    rounded to q's dtype: the values the reference's kernels multiply,
    widened to f32 as its dots take them."""
    qf, kf, vf, dof = q3.float(), k3.float(), v3.float(), do.float()
    p = torch.exp(_scores(q3, k3, scale, causal, mask2) - lse[..., None])
    delta = (dof * o.float()).sum(-1, keepdim=True)
    dp = _drop_probs(torch.matmul(dof, vf.transpose(1, 2)), seed, dropout_p)
    ds = (p * (dp - delta) * scale).to(q3.dtype).float()
    pd = _drop_probs(p, seed, dropout_p).to(do.dtype).float()
    return qf, kf, dof, pd, ds


def bwd_dq_reference(q3, k3, v3, o, lse, do, scale, causal, mask2=None,
                     seed=0, dropout_p=0.0):
    """Plain version of the dQ kernel: dq = ds k, in q's dtype."""
    _, kf, _, _, ds = _bwd_p_ds(q3, k3, v3, o, lse, do, scale, causal,
                                mask2, seed, dropout_p)
    return torch.matmul(ds, kf).to(q3.dtype)


def bwd_dkv_reference(q3, k3, v3, o, lse, do, scale, causal, mask2=None,
                      seed=0, dropout_p=0.0):
    """Plain version of the dK/dV kernel: (dk = ds^T q, dv = pd^T dO) in
    k's and v's dtypes."""
    qf, _, dof, pd, ds = _bwd_p_ds(q3, k3, v3, o, lse, do, scale, causal,
                                   mask2, seed, dropout_p)
    dk = torch.matmul(ds.transpose(1, 2), qf)
    dv = torch.matmul(pd.transpose(1, 2), dof)
    return dk.to(k3.dtype), dv.to(v3.dtype)


def flash_bwd_reference(q3, k3, v3, o, lse, do, scale, causal, mask2=None,
                        seed=0, dropout_p=0.0):
    """Plain version of the two backward kernels: (dq, dk, dv)."""
    a = (q3, k3, v3, o, lse, do, scale, causal, mask2, seed, dropout_p)
    return (bwd_dq_reference(*a), *bwd_dkv_reference(*a))


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


_TAIL = (ctypes.c_uint, ctypes.c_float, ctypes.c_float, ctypes.c_void_p)
_TC_HEAD_DIMS = (64, 128)


def flash_tc_route(dtype, d, ptrs) -> bool:
    """Whether a call takes the tensor-core kernels: bfloat16, head dim
    64 or 128, and every tensor TMA and bulk copies read (`ptrs`, from
    data_ptr(); read only when the rest holds) 16-byte aligned. Anything
    else (f32, other head dims up to 256, a misaligned view) takes the
    SIMT kernels; nothing is tried and caught."""
    return (dtype == torch.bfloat16 and d in _TC_HEAD_DIMS
            and all(p % 16 == 0 for p in ptrs))


def _tail(q3, t, mask2, seed, dropout_p):
    """(mask pointer, heads, the dropout arguments) of a launch."""
    bh = q3.shape[0]
    if mask2 is None:
        return 0, 1, _drop_args(seed, dropout_p)
    _check([("mask", mask2)], q3.device, torch.float32)
    b = mask2.shape[0]
    if mask2.dim() != 2 or mask2.shape[1] != t or b < 1 or bh % b:
        raise ValueError(f"flash mask must be (B, T) with B dividing BH = "
                         f"{bh} and T = {t}, got {tuple(mask2.shape)}")
    return mask2.data_ptr(), bh // b, _drop_args(seed, dropout_p)


def _launch(op, ins, outs, t, code, scale, causal, mask2, seed, dropout_p):
    """Launch `op`'s kernel on (*ins, *outs), ins[0] being q, on the route
    flash_tc_route picks from what the tensor-core kernel would copy in
    (ins and the mask), and count it under `op` and `op.tc` or
    `op.simt`."""
    q3 = ins[0]
    bh, s, d = q3.shape
    rb = ref_block(t)
    if rb not in _KERNEL_BLOCKS:
        raise ValueError(
            f"{op}: the reference rounds at key blocks of {rb} "
            f"(PADDLE_TPU_FLASH_BLOCK_K); the kernels round at "
            f"{_KERNEL_BLOCKS}")
    mptr, heads, (seed, on, thr, keep_div) = _tail(q3, t, mask2, seed,
                                                   dropout_p)
    copied = ins if mask2 is None else (*ins, mask2)
    route = "tc" if flash_tc_route(q3.dtype, d, (x.data_ptr()
                                                 for x in copied)) else "simt"
    symbol = f"{op}_tc_launch" if route == "tc" else f"{op}_launch"
    fn = _build.function("flash_attention", symbol,
                         len(ins) + len(outs) + 1, 10, _TAIL)
    stream = torch.cuda.current_stream(q3.device).cuda_stream
    with torch.cuda.device(q3.device):
        err = fn(*(x.data_ptr() for x in (*ins, *outs)), mptr, bh, s, t, d,
                 code, int(causal), heads, seed, on, rb, thr,
                 keep_div, float(scale), stream)
    _raise_if(err, op)
    _build.note_launch(op)
    _build.note_launch(f"{op}.{route}")


def _fwd_kernel(q3, k3, v3, scale, causal, mask2=None, seed=0,
                dropout_p=0.0):
    bh, s, t, d, code = _dims(q3, k3, v3)
    o = torch.empty_like(q3)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q3.device)
    _launch("flash_fwd", (q3, k3, v3), (o, lse), t, code, scale, causal,
            mask2, seed, dropout_p)
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


def _dq_kernel(q3, k3, v3, do, lse, delta, scale, causal, mask2=None,
               seed=0, dropout_p=0.0):
    bh, s, t, d, code = _bwd_common(q3, k3, v3, do, lse, delta)
    dq = torch.empty_like(q3)
    _launch("flash_bwd_dq", (q3, k3, v3, do, lse, delta), (dq,), t, code,
            scale, causal, mask2, seed, dropout_p)
    return dq


def _dkv_kernel(q3, k3, v3, do, lse, delta, scale, causal, mask2=None,
                seed=0, dropout_p=0.0):
    bh, s, t, d, code = _bwd_common(q3, k3, v3, do, lse, delta)
    dk = torch.empty_like(k3)
    dv = torch.empty_like(v3)
    _launch("flash_bwd_dkv", (q3, k3, v3, do, lse, delta), (dk, dv), t,
            code, scale, causal, mask2, seed, dropout_p)
    return dk, dv


def bwd_delta(o, do):
    """delta = rowsum(dO * O) in f32, (BH, S): computed in PyTorch, as
    the reference computes it in jnp."""
    return (do.float() * o.float()).sum(-1)


def _bwd_kernels(q3, k3, v3, o, lse, do, scale, causal, mask2=None, seed=0,
                 dropout_p=0.0):
    delta = bwd_delta(o, do)
    a = (q3, k3, v3, do, lse, delta, scale, causal, mask2, seed, dropout_p)
    dq = _dq_kernel(*a)
    dk, dv = _dkv_kernel(*a)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q3, k3, v3, mask2, scale, causal, seed, dropout_p):
        args = (scale, causal, mask2, seed, dropout_p)
        if _route(q3, "flash_attention"):
            o, lse = _fwd_kernel(q3, k3, v3, *args)
        else:
            o, lse = flash_fwd_reference(q3, k3, v3, *args)
        ctx.save_for_backward(q3, k3, v3, o, lse)
        ctx.args = args
        return o

    @staticmethod
    def backward(ctx, do):
        q3, k3, v3, o, lse = ctx.saved_tensors
        do = do.contiguous()
        if _route(q3, "flash_attention"):
            grads = _bwd_kernels(q3, k3, v3, o, lse, do, *ctx.args)
        else:
            grads = flash_bwd_reference(q3, k3, v3, o, lse, do, *ctx.args)
        return (*grads, None, None, None, None, None)


def flash_attention(q, k, v, mask=None, scale=None, causal=False,
                    dropout_p=0.0, dropout_seed=0):
    """q, k, v: (B, H, S|T, D) -> (B, H, S, D), differentiable in q, k,
    v; mask: additive (B, 1, 1, T) or None. CPU tensors take the plain
    versions; CUDA tensors the kernels."""
    if not can_use_flash(q, k, v, mask):
        raise ValueError(
            f"flash_attention takes (B, H, S, D) with D % 8 == 0, D <= 256, "
            f"S, T multiples of {_MIN_BLOCK} and a (B, 1, 1, T) mask or "
            f"none; got q {tuple(q.shape)}, k {tuple(k.shape)}, mask "
            f"{None if mask is None else tuple(mask.shape)}")
    b, h, s, d = q.shape
    t = k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    q3 = q.reshape(b * h, s, d).contiguous()
    k3 = k.reshape(b * h, t, d).contiguous()
    v3 = v.reshape(b * h, t, d).contiguous()
    mask2 = None
    if mask is not None:
        mask2 = mask.detach().reshape(b, t).float().contiguous()
    o = _Flash.apply(q3, k3, v3, mask2, float(scale), bool(causal),
                     int(dropout_seed), float(dropout_p))
    return o.reshape(b, h, s, d)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, seed=0):
    """(B, H, S, D) attention as the layers call it: dropout only in
    training, from the int32 `seed`; the flash kernels where
    can_use_flash admits the call, sdpa_reference otherwise."""
    p = float(dropout_p) if training else 0.0
    if can_use_flash(query, key, value, attn_mask):
        return flash_attention(query, key, value, attn_mask, None,
                               is_causal, p, seed)
    return sdpa_reference(query, key, value, attn_mask, None, is_causal, p,
                          seed)

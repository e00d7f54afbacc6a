"""Fused transformer FFN, y = act(x @ W1 + b1) @ W2 + b2 (counterpart of
``paddle_tpu/ops/pallas_ffn.py``, B row 10).

  * ``fused_ffn(x, w1, b1, w2, b2, act_name="gelu")`` on x [..., H]: a
    ``torch.autograd.Function``. CUDA tensors launch the kernel of
    ``csrc/fused_ffn.cu`` (the (M, I) intermediate stays on chip) or the
    call raises; CPU tensors take ``ffn_reference``. The backward is the
    reference's own (``_fused_ffn_bwd``): a composed f32 recompute of the
    chain under autograd, with the activation's formula but without the
    rounding of hid, each gradient cast to its input's type.
  * ``ffn_reference`` — the plain version of the kernel: a = x @ W1 + b1
    in f32, hid = act(a) rounded to x's type, y = hid @ W2 + b2 in f32,
    rounded to x's type (pallas_ffn.py:124-140).
  * ``can_use_fused_ffn(m, h, i, itemsize)`` — the reference's gate on
    the alignment terms (m % 256, h % 128, i % 512, h <= 4096) and its
    switches (``PADDLE_TPU_DISABLE_PALLAS``,
    ``PADDLE_TPU_DISABLE_FFN_FUSION``, and the port's
    ``nn.functional.composed_ops()``). The reference's TPU-only terms (on
    a TPU or in interpret mode, the VMEM budget) have no counterpart.
  * ``ffn_wins`` is True: the measured per-shape arbitration is the
    autobench gate (ROADMAP.md A, item 3).

The kernel takes float32 or bfloat16 (one type for x, the weights and the
biases), any M >= 1, H and I >= 1.
"""
from __future__ import annotations

import ctypes
import os

import torch

from . import _build
from ._launch import _check, _dtype_code, _raise_if, _route
from .fused_block import ACTS, _grads_of

__all__ = ["fused_ffn", "ffn_reference", "can_use_fused_ffn", "ffn_wins"]


def can_use_fused_ffn(m: int, h: int, i: int, itemsize: int = 4) -> bool:
    if os.environ.get("PADDLE_TPU_DISABLE_PALLAS"):
        return False
    if os.environ.get("PADDLE_TPU_DISABLE_FFN_FUSION"):
        return False
    from ..nn import functional as _F
    if _F._composed:
        return False
    return (m % 256 == 0 and h % 128 == 0 and i % 512 == 0
            and h <= 4096)


def ffn_wins(m, h, i, dtype, act="gelu") -> bool:
    return True


def _act(act_name):
    if act_name not in ACTS:
        raise ValueError(f"fused_ffn supports gelu/gelu_tanh/relu, got "
                         f"{act_name!r}")
    return ACTS[act_name]


def ffn_reference(x2, w1, b1, w2, b2, act_name="gelu"):
    """Plain version of the kernel on x2 (M, H), in x2's type."""
    hid = _act(act_name)[1](x2.float() @ w1.float() + b1.float())
    hid = hid.to(x2.dtype).float()
    return (hid @ w2.float() + b2.float()).to(x2.dtype)


def _chain_f32(x2, w1, b1, w2, b2, act_name):
    """The reference's backward chain: f32 throughout, hid not rounded."""
    return _act(act_name)[1](x2 @ w1 + b1) @ w2 + b2


def _ffn_kernel(x2, w1, b1, w2, b2, act_name):
    m, hd = x2.shape
    i = w1.shape[1]
    code = _dtype_code(x2, "fused_ffn")
    _check([("x", x2), ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)],
           x2.device, x2.dtype)
    if w1.shape[0] != hd or tuple(w2.shape) != (i, hd) \
            or tuple(b1.shape) != (i,) or tuple(b2.shape) != (hd,):
        raise ValueError(f"fused_ffn shapes: x {tuple(x2.shape)}, w1 "
                         f"{tuple(w1.shape)}, b1 {tuple(b1.shape)}, w2 "
                         f"{tuple(w2.shape)}, b2 {tuple(b2.shape)}")
    act_code = _act(act_name)[0]
    y = torch.empty_like(x2)
    fn = _build.function("fused_ffn", "fused_ffn_launch", 6, 5,
                         (ctypes.c_void_p,))
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    with torch.cuda.device(x2.device):
        err = fn(x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                 b2.data_ptr(), y.data_ptr(), m, hd, i, code, act_code, stream)
    _raise_if(err, "fused_ffn")
    _build.note_launch("fused_ffn")
    return y


class _Ffn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, w1, b1, w2, b2, act_name):
        ctx.act_name = act_name
        ctx.save_for_backward(x2, w1, b1, w2, b2)
        if _route(x2, "fused_ffn"):
            return _ffn_kernel(x2, w1, b1, w2, b2, act_name)
        return ffn_reference(x2, w1, b1, w2, b2, act_name)

    @staticmethod
    def backward(ctx, dy):
        act_name = ctx.act_name
        grads = _grads_of(lambda *t: _chain_f32(*t, act_name),
                          ctx.saved_tensors, (dy,))
        return (*grads, None)


def fused_ffn(x, w1, b1, w2, b2, act_name="gelu"):
    """x [..., H] -> [..., H] in x's type; the (M, I) intermediate stays
    on chip. Differentiable in all five tensors (composed f32
    backward)."""
    _act(act_name)
    h = x.shape[-1]
    x2 = x.reshape(-1, h)
    return _Ffn.apply(x2, w1, b1, w2, b2, act_name).reshape(x.shape)

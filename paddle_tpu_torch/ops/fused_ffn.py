"""Fused transformer FFN, y = act(x @ W1 + b1) @ W2 + b2 (counterpart of
``paddle_tpu/ops/pallas_ffn.py``, B row 10).

  * ``fused_ffn(x, w1, b1, w2, b2, act_name="gelu")`` on x [..., H]: a
    ``torch.autograd.Function``. CUDA tensors launch the kernels of
    ``csrc/fused_ffn.cu`` on the route ``ffn_route`` picks, or the call
    raises; CPU tensors take ``ffn_reference``. The backward is the
    reference's own (``_fused_ffn_bwd``): a composed f32 recompute of the
    chain under autograd, with the activation's formula but without the
    rounding of hid, each gradient cast to its input's type.
  * ``ffn_route(dtype, m, h, i, ptrs, sms)`` — the route of a call, by
    the rules of rows 2-3 (``fused_block.tc_route``, ``ffma_route``,
    ``ffma_tiles``): "tc" (bf16, H and I multiples of 64, 16-byte
    aligned: two wgmma products, hid through device memory in bf16),
    "ffma" (f32 from 128 rows at such widths: two register-tiled FFMA
    products, hid in f32, each on its own tile) or "simt" (everything
    else: one launch, hid kept on chip). Each call counts under
    ``fused_ffn`` and ``fused_ffn.<route>``.
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

The kernels take float32 or bfloat16 (one type for x, the weights and the
biases), any M >= 1, H and I >= 1 (the tc and ffma routes only widths
that are multiples of 64).
"""
from __future__ import annotations

import ctypes
import os

import torch

from . import _build
from ._launch import _check, _dtype_code, _route, _sms
from .fused_block import (_FFMA_TILES, ACTS, _grads_of, _run, ffma_route,
                          ffma_tiles, tc_route)

__all__ = ["fused_ffn", "ffn_reference", "can_use_fused_ffn", "ffn_wins",
           "ffn_route"]


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


def ffn_route(dtype, m, h, i, ptrs, sms):
    """(route, tiles) of a fused_ffn call on x (m, h) with I = i, whose
    tensors sit at the addresses `ptrs`, on a card of `sms`
    multiprocessors: ("tc", None), ("ffma", (tile of the (m, i) product,
    tile of the (m, h) product)) or ("simt", None). Pure: the wrapper
    asks it before the launch, nothing is tried and caught."""
    if tc_route(dtype, (h, i), ptrs):
        return "tc", None
    if ffma_route(dtype, m, (h, i), ptrs):
        return "ffma", (ffma_tiles(m, i, sms), ffma_tiles(m, h, sms))
    return "simt", None


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
    _build.library("fused_ffn")  # built (or raising) before the card is asked
    y = torch.empty_like(x2)
    ptrs = [t.data_ptr() for t in (x2, w1, b1, w2, b2)]
    route, tiles = ffn_route(x2.dtype, m, hd, i, ptrs,
                             _sms(x2.device.index))
    args = [t.data_ptr() for t in (x2, w1, b1, w2, b2, y)]
    if route == "tc":
        hid = torch.empty((m, i), dtype=x2.dtype, device=x2.device)
        fn = _build.function("fused_ffn", "fused_ffn_tc_launch", 7, 4,
                             (ctypes.c_void_p,))
        _run(x2.device, "fused_ffn", fn, *args, hid.data_ptr(), m, hd, i,
             act_code)
    elif route == "ffma":
        hid = torch.empty((m, i), dtype=torch.float32, device=x2.device)
        fn = _build.function("fused_ffn", "fused_ffn_ffma_launch", 7, 6,
                             (ctypes.c_void_p,))
        _run(x2.device, "fused_ffn", fn, *args, hid.data_ptr(), m, hd, i,
             *(_FFMA_TILES.index(t) for t in tiles), act_code)
    else:
        fn = _build.function("fused_ffn", "fused_ffn_launch", 6, 5,
                             (ctypes.c_void_p,))
        _run(x2.device, "fused_ffn", fn, *args, m, hd, i, code, act_code)
    _build.note_launch("fused_ffn")
    _build.note_launch(f"fused_ffn.{route}")
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
    """x [..., H] -> [..., H] in x's type, on the route ffn_route picks.
    Differentiable in all five tensors (composed f32 backward)."""
    _act(act_name)
    h = x.shape[-1]
    x2 = x.reshape(-1, h)
    return _Ffn.apply(x2, w1, b1, w2, b2, act_name).reshape(x.shape)

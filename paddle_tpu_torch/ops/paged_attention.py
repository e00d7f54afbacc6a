"""Ragged paged-attention decode (counterpart of
``paddle_tpu/ops/paged_attention.py``).

The serving tier stores each request's KV history in fixed-size pages of
a preallocated device pool; decode computes one new token per in-flight
request ("slot") against its own ragged-length history.

  * ``paged_attention_reference`` — the plain PyTorch port of
    ``paged_attention_xla``: gather each slot's pages into a
    ``[S, M*ps]`` context, mask past ``ctx_len``, softmax. The tests and
    the on-card comparison use it; it runs for CPU tensors.
  * ``paged_attention_decode`` — the entry point. A CPU tensor goes to
    the reference; a CUDA tensor goes to the hand-written kernel in
    ``csrc/paged_attention.cu`` or the call raises.

Layouts:
  q          [S, H, d]        one query token per slot (float32)
  k/v_pages  [P, ps, H, d]    the page pools (float32 or bfloat16)
  page_table [S, M] int32     pool index of each slot's m-th page
  ctx_lens   [S] int32        valid history length per slot
Returns     [S, H, d] in q's dtype
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["paged_attention_decode", "paged_attention_reference"]

_NEG = -1e30
_MAX_HEAD_DIM = 128
_MAX_PAGE = 128


def paged_attention_reference(q, k_pages, v_pages, page_table, ctx_lens,
                              scale=None):
    """Gather-based plain version (port of paged_attention_xla)."""
    S, H, d = q.shape
    ps = k_pages.shape[1]
    M = page_table.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    idx = page_table.long()
    k = k_pages[idx].reshape(S, M * ps, H, d)
    v = v_pages[idx].reshape(S, M * ps, H, d)
    logits = torch.einsum("shd,sthd->sht", q.float(), k.float()) * scale
    pos = torch.arange(M * ps, device=q.device)[None, :]
    logits = torch.where(pos[:, None, :] < ctx_lens.long()[:, None, None],
                         logits, torch.full_like(logits, _NEG))
    probs = torch.softmax(logits, dim=-1)
    o = torch.einsum("sht,sthd->shd", probs.to(v.dtype), v)
    return o.to(q.dtype)


def _check(q, k_pages, v_pages, page_table, ctx_lens):
    dev = q.device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("ctx_lens", ctx_lens)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    if q.dtype != torch.float32:
        raise TypeError(f"q must be float32, got {q.dtype}")
    if k_pages.dtype not in (torch.float32, torch.bfloat16) \
            or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"k/v pages must share float32 or bfloat16, got "
                        f"{k_pages.dtype}/{v_pages.dtype}")
    if page_table.dtype != torch.int32 or ctx_lens.dtype != torch.int32:
        raise TypeError("page_table and ctx_lens must be int32")
    if q.dim() != 3 or k_pages.dim() != 4 \
            or k_pages.shape != v_pages.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k/v "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}")
    S, H, d = q.shape
    ps = k_pages.shape[1]
    if tuple(k_pages.shape[2:]) != (H, d):
        raise ValueError(f"pages [P, ps, H, d] must match q's (H, d) = "
                         f"{(H, d)}, got {tuple(k_pages.shape)}")
    if page_table.dim() != 2 or page_table.shape[0] != S \
            or tuple(ctx_lens.shape) != (S,):
        raise ValueError(f"page_table [S, M] / ctx_lens [S] with S={S}, got "
                         f"{tuple(page_table.shape)} / "
                         f"{tuple(ctx_lens.shape)}")
    if d > _MAX_HEAD_DIM or ps > _MAX_PAGE:
        raise ValueError(f"kernel takes head_dim <= {_MAX_HEAD_DIM} and "
                         f"page_size <= {_MAX_PAGE}, got {d}, {ps}")


def _launch_kernel(q, k_pages, v_pages, page_table, ctx_lens, scale):
    _check(q, k_pages, v_pages, page_table, ctx_lens)
    S, H, d = q.shape
    ps = k_pages.shape[1]
    M = page_table.shape[1]
    out = torch.empty_like(q)
    fn = _build.function("paged_attention", "paged_attention_launch", 6, 5,
                         (ctypes.c_float, ctypes.c_int, ctypes.c_void_p))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 page_table.data_ptr(), ctx_lens.data_ptr(), out.data_ptr(),
                 S, H, d, ps, M, float(scale),
                 int(k_pages.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    _build.note_launch("paged_attention")
    return out


def paged_attention_decode(q, k_pages, v_pages, page_table, ctx_lens,
                           scale=None):
    """Ragged paged-attention decode; see the module docstring. CPU
    tensors take the plain version, CUDA tensors the kernel."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, page_table,
                                         ctx_lens, scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_decode: no kernel for device "
                         f"{q.device}")
    return _launch_kernel(q, k_pages, v_pages, page_table, ctx_lens, scale)

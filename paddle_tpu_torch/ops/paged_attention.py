"""Ragged paged-attention decode (counterpart of
``paddle_tpu/ops/paged_attention.py``).

The serving tier stores each request's KV history in fixed-size pages of
a preallocated device pool; decode computes one new token per in-flight
request ("slot") against its own ragged-length history.

  * ``paged_attention_reference`` — the plain PyTorch port of
    ``paged_attention_xla``: gather each slot's pages into a
    ``[S, M*ps]`` context, mask past ``ctx_len``, softmax. The tests and
    the on-card comparison use it; it runs for CPU tensors.
  * ``paged_attention_split_reference`` — the kernel's algorithm in
    tensors: the table's pages cut into splits of ``pages_per_split``,
    each split's masked softmax kept as (max, sum, P V) with P in f32,
    the splits combined in split order; a slot with ctx 0 gives 0, as
    the Pallas kernel's l == 0 -> 1 rule does (the gather path gives
    the mean of V there).
  * ``paged_splits(S, H, M, sms)`` — the pages a split of the kernel's
    grid (S, H, splits) takes, from the table's shape and the card's
    multiprocessor count alone (never from ctx_lens, which live on the
    device: the launch needs no host sync).
  * ``paged_route`` — which of the two kernels in
    ``csrc/paged_attention.cu`` takes a call on the card: "vector"
    (16-byte cp.async rows: q f32, pools f32 or bf16, d <= 128, rows of
    whole 16-byte pieces, aligned and contiguous; the serving shapes) or
    "scalar" (plain loads, pools by their strides: any other call of
    f32, bf16 or f16 tensors, d <= 16384). Decided from dtypes, shapes
    and pointers alone (never ctx_lens: the route needs no host sync).
  * ``paged_attention_decode`` — the entry point. A CPU tensor goes to
    the gather plain version; a CUDA tensor to the kernel of its route,
    or the call raises. Every launch counts under ``paged_attention``
    and under its route, ``paged_attention.vector`` or
    ``paged_attention.scalar``.

Layouts:
  q          [S, H, d]        one query token per slot
  k/v_pages  [P, ps, H, d]    the page pools (one dtype)
  page_table [S, M] int32     pool index of each slot's m-th page
  ctx_lens   [S] int32        valid history length per slot
Returns     [S, H, d] in q's dtype
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from ._launch import _sms, workspace

__all__ = ["paged_attention_decode", "paged_attention_reference",
           "paged_attention_split_reference", "paged_splits",
           "paged_route"]

_NEG = -1e30
_MAX_HEAD_DIM = 128        # the vector route's
_SCALAR_MAX_DIM = 16384    # the scalar route's (q and P V in smem)
_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_BLOCKS_PER_SM = 12     # paged_splits' target of blocks an SM


def paged_splits(S: int, H: int, M: int, sms: int) -> int:
    """Pages per split of the kernel's grid (S, H, ceil(M / pps)) for a
    page table of M columns on a card of `sms` multiprocessors: enough
    splits that the grid holds _BLOCKS_PER_SM blocks an SM when every
    slot's table is full, at most one split a page. A block streams its
    pages at about one SM's share of the card's bandwidth, so the slot
    with the longest context sets the time unless its pages are spread
    over many blocks; ctx_lens cannot tell the host which slot that is.
    Twelve blocks an SM (three are resident at d = 128 in f32) is the
    pick that chip_smoke.py's split_ms holds against the other splits,
    at ctx 1 ... 2048 and with every table full (PERF.md). At 132 SMs,
    S = 8 and H = 16
    (GPT-3 XL decode), M = 128 takes 10 pages a split (13 splits); S * H
    >= 1584 takes one split (nothing to merge)."""
    splits = max(1, min(M, math.ceil(_BLOCKS_PER_SM * sms / (S * H))))
    return math.ceil(M / splits)


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


def paged_attention_split_reference(q, k_pages, v_pages, page_table,
                                    ctx_lens, pages_per_split, scale=None):
    """Split-and-merge plain version (the kernel's algorithm in tensors)
    at `pages_per_split` pages a split (the kernel's is paged_splits'
    pick for the card)."""
    S, H, d = q.shape
    ps = k_pages.shape[1]
    M = page_table.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    pps = pages_per_split
    ctx = ctx_lens.long().clamp(0, M * ps)
    qf = q.float()
    ms, ls, accs = [], [], []
    for p0 in range(0, M, pps):
        idx = page_table[:, p0:p0 + pps].long()
        n = idx.shape[1] * ps
        k = k_pages[idx].reshape(S, n, H, d).float()
        v = v_pages[idx].reshape(S, n, H, d).float()
        logits = torch.einsum("shd,sthd->sht", qf, k) * scale
        pos = p0 * ps + torch.arange(n, device=q.device)
        valid = (pos[None, :] < ctx[:, None])[:, None, :]
        logits = torch.where(valid, logits, torch.full_like(logits, _NEG))
        m = logits.amax(-1)
        p = torch.where(valid, torch.exp(logits - m[..., None]),
                        torch.zeros_like(logits))
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("sht,sthd->shd", p, v))
    m = torch.stack(ms)
    f = torch.exp(m - m.amax(0))
    l = (torch.stack(ls) * f).sum(0)
    acc = (torch.stack(accs) * f[..., None]).sum(0)
    l = torch.where(l == 0, torch.ones_like(l), l)
    return (acc / l[..., None]).to(q.dtype)


def paged_route(q_dtype, kv_dtype, d, ptrs, contiguous=True) -> str:
    """The kernel that takes a decode call on the card: "vector" (the
    cp.async kernel) when q is float32, the K/V pools float32 or
    bfloat16, head_dim d <= 128, a K/V row of d * itemsize bytes a
    multiple of 16, and both pools contiguous (`contiguous`) at 16-byte
    aligned addresses (`ptrs`, from data_ptr()); "scalar" (plain loads,
    pools by their strides) for every other call of float32, bfloat16
    or float16 tensors with d <= 16384; anything else raises. Both take
    any page size. Pure: decided from dtypes, shapes and pointers
    before any launch, never from ctx_lens (they live on the device:
    the route needs no host sync)."""
    for what, dt in (("q", q_dtype), ("k/v pages", kv_dtype)):
        if dt not in _TYPE_CODES:
            raise TypeError(f"paged attention kernels take float32, "
                            f"bfloat16 or float16 {what}, got {dt}")
    if d > _SCALAR_MAX_DIM:
        raise ValueError(f"paged attention kernels take head_dim <= "
                         f"{_SCALAR_MAX_DIM}, got {d}")
    item = kv_dtype.itemsize
    if (q_dtype == torch.float32
            and kv_dtype in (torch.float32, torch.bfloat16) and contiguous
            and d <= _MAX_HEAD_DIM and d * item % 16 == 0
            and all(p % 16 == 0 for p in ptrs)):
        return "vector"
    return "scalar"


def _check(q, k_pages, v_pages, page_table, ctx_lens) -> str:
    """The route of a decode call (paged_route, which raises on what
    neither kernel takes), once the call is what any decode call must
    be: one device, the two pools of one dtype, int32 table and lengths,
    shapes that agree."""
    dev = q.device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("ctx_lens", ctx_lens)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
    if v_pages.dtype != k_pages.dtype:
        raise TypeError(f"k/v pages must be of one dtype, got "
                        f"{k_pages.dtype}/{v_pages.dtype}")
    if page_table.dtype != torch.int32 or ctx_lens.dtype != torch.int32:
        raise TypeError("page_table and ctx_lens must be int32")
    if q.dim() != 3 or k_pages.dim() != 4 \
            or k_pages.shape != v_pages.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k/v "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}")
    S, H, d = q.shape
    if tuple(k_pages.shape[2:]) != (H, d):
        raise ValueError(f"pages [P, ps, H, d] must match q's (H, d) = "
                         f"{(H, d)}, got {tuple(k_pages.shape)}")
    if page_table.dim() != 2 or page_table.shape[0] != S \
            or tuple(ctx_lens.shape) != (S,):
        raise ValueError(f"page_table [S, M] / ctx_lens [S] with S={S}, got "
                         f"{tuple(page_table.shape)} / "
                         f"{tuple(ctx_lens.shape)}")
    return paged_route(q.dtype, k_pages.dtype, d,
                       (k_pages.data_ptr(), v_pages.data_ptr()),
                       k_pages.is_contiguous() and v_pages.is_contiguous())


def _launch(q, k_pages, v_pages, page_table, ctx_lens, scale):
    """The call on its route's kernel (_check). q, page_table and
    ctx_lens are made contiguous; the scalar route takes the pools by
    their strides."""
    q, page_table, ctx_lens = (t.contiguous()
                               for t in (q, page_table, ctx_lens))
    route = _check(q, k_pages, v_pages, page_table, ctx_lens)
    S, H, d = q.shape
    ps = k_pages.shape[1]
    M = page_table.shape[1]
    pps = paged_splits(S, H, M, _sms(q.device.index))
    splits = math.ceil(M / pps)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    # the split workspace and tickets of this stream (ops/_launch.py),
    # shared with the other kernels that launch on it
    part = tickets = None
    if splits > 1:
        part = workspace(q.device, stream, "part",
                         S * H * splits * (d + 2)).data_ptr()
        tickets = workspace(q.device, stream, "tickets", S * H,
                            torch.int32).data_ptr()
    args = [q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), ctx_lens.data_ptr(), out.data_ptr(),
            part, tickets, S, H, d, ps, M, pps, float(scale)]
    if route == "vector":
        fn = _build.function("paged_attention", "paged_attention_launch", 8,
                             6, (ctypes.c_float, ctypes.c_int,
                                 ctypes.c_void_p))
        args.append(int(k_pages.dtype == torch.bfloat16))
    else:
        fn = _build.function("paged_attention",
                             "paged_attention_scalar_launch", 8, 6,
                             (ctypes.c_float, ctypes.c_int, ctypes.c_int)
                             + (ctypes.c_longlong,) * 8 + (ctypes.c_void_p,))
        args += [_TYPE_CODES[q.dtype], _TYPE_CODES[k_pages.dtype],
                 *k_pages.stride(), *v_pages.stride()]
    with torch.cuda.device(q.device):
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel ({route} route) launch "
                           f"failed: CUDA error {err}")
    _build.note_launch("paged_attention")
    _build.note_launch(f"paged_attention.{route}")
    return out


def paged_attention_decode(q, k_pages, v_pages, page_table, ctx_lens,
                           scale=None):
    """Ragged paged-attention decode; see the module docstring. CPU
    tensors take the plain version; CUDA tensors the kernel of their
    route (paged_route)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, page_table,
                                         ctx_lens, scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_decode: no kernel for device "
                         f"{q.device}")
    return _launch(q, k_pages, v_pages, page_table, ctx_lens, scale)

"""Ring attention: sequence (context) parallelism over the "sp" axis
(counterpart of ``paddle_tpu/parallel/sequence_parallel.py``).

The sequence is cut over the ranks of the sp axis. Each rank keeps its
block of queries and an online-softmax accumulator; the key and value
blocks travel round the ring, one hop to the next rank a step, so every
rank sees the whole sequence in n steps while it holds 1/n of K and V
at a time. The reference's loop is a ``lax.scan`` of ``ppermute`` hops
inside a ``shard_map``, and its backward is the reverse ring because
the transpose of ``ppermute`` is the opposite rotation. The port runs
one process per rank, so a hop is an autograd function (``_Hop``): its
forward sends K and V (stacked, one message) to rank + 1 and receives
from rank - 1, its backward sends their gradient to rank - 1 and
receives from rank + 1, and the per-block arithmetic is left to
autograd (recomputed with the layer under remat).

Every rank of a ring must make the same hops in the same order, the
backward's too. Under causal masking a block wholly in the future of
this rank's rows is skipped, but its hop still runs; the last block's
K and V are tied to the output with a zero gradient (``_Tie``), so that
on every rank the backward runs all n - 1 hops even where the last
blocks were skipped.

Arithmetic as the reference's einsums: scores in float32 from the
inputs' values, P rounded to V's type before the second product, that
product accumulated in float32, the result cast to q's type. Hops go
through ``comm.Comm.shift`` on the sp axis's own group (host copies
where gloo carries CUDA tensors), timed under "sp".
"""
from __future__ import annotations

import contextlib
import math

import torch

from .comm import Comm

__all__ = ["ring_attention", "ring_context", "current_ring"]

_NEG = -1e30

_ring_stack: list = []


@contextlib.contextmanager
def ring_context(mesh, axis: str = "sp", comm: Comm | None = None):
    """Marks the mesh axis model code ring-attends over (read by
    ``models/gpt.py`` when cfg.attn_impl == "ring"); `comm` times the
    hops (a fresh ``Comm`` when None)."""
    _ring_stack.append((mesh, axis, comm))
    try:
        yield
    finally:
        _ring_stack.pop()


def current_ring():
    """(mesh, axis) of the innermost ``ring_context``, or None."""
    return _ring_stack[-1][:2] if _ring_stack else None


class _Ring:
    """A rank's place on the ring: the axis's group, the world ranks it
    sends to (next) and receives from (prev), the timer."""

    def __init__(self, mesh, axis, comm):
        self.n = mesh.axis_size(axis)
        self.idx = mesh.coord(axis)
        self.group = mesh.group(axis)
        self.next = mesh.rank_at(**{axis: (self.idx + 1) % self.n})
        self.prev = mesh.rank_at(**{axis: (self.idx - 1) % self.n})
        self.comm = comm

    def hop(self, t, forward: bool):
        dst, src = (self.next, self.prev) if forward else \
            (self.prev, self.next)
        return self.comm.shift(t, dst, src, self.group, "sp")


class _Hop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kv, ring):
        ctx.ring = ring
        return ring.hop(kv, True)

    @staticmethod
    def backward(ctx, dkv):
        return ctx.ring.hop(dkv.contiguous(), False), None


class _Tie(torch.autograd.Function):
    """`out` unchanged; a zero gradient for `kv`."""

    @staticmethod
    def forward(ctx, out, kv):
        ctx.meta = (kv.shape, kv.dtype, kv.device)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, dout):
        shape, dtype, device = ctx.meta
        return dout, torch.zeros(shape, dtype=dtype, device=device)


def _comm_for(mesh, axis) -> Comm:
    for m, a, comm in reversed(_ring_stack):
        if m is mesh and a == axis and comm is not None:
            return comm
    return Comm()


def _update(q, kb, vb, acc, m, l, scale, rows, cols):
    """Fold one K/V block into the online-softmax state (acc, m, l)."""
    s = torch.matmul(q.float(), kb.float().transpose(-1, -2)) * scale
    if rows is not None:
        s = torch.where(rows[:, None] >= cols[None, :], s, _NEG)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l = alpha * l + p.sum(-1)
    acc = acc * alpha[..., None] + torch.matmul(p.to(vb.dtype).float(),
                                                vb.float())
    return acc, m_new, l


def ring_attention(q, k, v, mesh, axis: str = "sp", causal: bool = False,
                   scale=None):
    """q, k, v: this rank's [B, H, S, D] shards of a sequence cut over
    `axis` (global S = n * S). Returns this rank's [B, H, S, D] shard of
    the attention output.

    Causal masking uses global row and column ids, so the result is
    dense causal attention's; a block wholly in the future of this
    rank's rows is skipped, its hop kept. `mesh` is a
    ``distributed.mesh.Mesh``; at one rank on the axis this is
    ``_dense``."""
    n = mesh.axis_size(axis)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if n == 1:
        return _dense(q, k, v, causal, scale)
    ring = _Ring(mesh, axis, _comm_for(mesh, axis))
    idx = ring.idx
    S = q.shape[2]
    rows = None
    if causal:
        ar = torch.arange(S, device=q.device)
        rows = idx * S + ar

    def cols(src):
        return None if rows is None else src * S + ar

    shape = q.shape[:3]
    # hop 0 is the local block: fold it in first, so the loop makes
    # exactly n - 1 rotations
    acc, m, l = _update(
        q, k, v, torch.zeros(q.shape, dtype=torch.float32, device=q.device),
        torch.full(shape, _NEG, dtype=torch.float32, device=q.device),
        torch.zeros(shape, dtype=torch.float32, device=q.device),
        scale, rows, cols(idx))
    kv = torch.stack([k, v])
    skipped = False
    for i in range(1, n):
        kv = _Hop.apply(kv, ring)
        src = (idx - i) % n
        skipped = causal and src > idx
        if not skipped:
            acc, m, l = _update(q, kv[0], kv[1], acc, m, l, scale, rows,
                                cols(src))
    if skipped:
        acc = _Tie.apply(acc, kv)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l[..., None]).to(q.dtype)


def _dense(q, k, v, causal, scale):
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        T = q.shape[2]
        mask = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask, s, _NEG)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)

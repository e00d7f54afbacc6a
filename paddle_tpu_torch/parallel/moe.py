"""Mixture-of-Experts with expert parallelism over the "ep" axis
(counterpart of ``paddle_tpu/parallel/moe.py``).

The reference routes GShard / Switch style: top-k experts a token with
a static capacity C an expert (overflow tokens dropped, their residual
carrying them), one-hot ``[N, E, C]`` dispatch and combine einsums, the
router in float32. The port computes the same function without the
one-hot tensors (335 MB in float32 at 8 × 1024 tokens and 8 experts):
a token's (expert, slot) pairs come from the same cumulative counts,
``index_copy`` fills the ``[E, C, D]`` expert buffers, and a gather and
``index_add`` combine. With one term a slot this equals the einsums;
at top-2 a token's two terms are summed (two terms sum alike in either
order). ``topk_gating`` keeps the reference's dense outputs for callers
that want them.

Inside ``moe_context(mesh)`` (the hybrid train step) the reference's
``moe_ffn`` sees the global batch; a rank of the port holds only its
rows (dp) and columns (sp), so:
  * the capacity is that of the global token count;
  * a token's slot counts the tokens routed to its expert before it in
    global row-major [B, T] order, on every rank: the per-(row, expert)
    counts are all-gathered over the (dp, sp) group before the slots
    are assigned;
  * the aux loss's f and p are means over the global tokens; the aux a
    rank returns is its share: summed over sp and averaged over dp (as
    the train step combines the losses) it is the reference's;
  * tokens are replicated over ep (and tp): every ep rank routes its
    tokens alike and runs its E/ep experts, each split Megatron-style
    over tp (``we_up`` on columns, ``we_down`` on rows). The down
    projection's tp partials are products in float32, summed over tp
    before they round to the compute type and take ``be_down``: the
    rounding points of the unsplit expert, so that tp changes the
    function by float32 sums in another order only (a bf16 partial
    rounded before the sum moves a token's output by bf16 ulps, and
    top-1 routing in the later layers turns that into a token sent to
    another expert). The combine is a partial over ep, summed over ep:
    forward all-reduce, backward identity. The tokens entering the
    experts have a partial cotangent, summed over (ep, tp), and the
    kept gates one summed over ep, by the conjugate copy
    (``_CopyTokens``); the router, its probabilities and the aux loss
    are replicated and their gradient counted once.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.nn.functional as F

from ..ops.fused_block import gelu_tanh
from .comm import Comm, group_size
from .tensor_parallel import TP, reduce_from_tp

__all__ = ["moe_capacity", "topk_gating", "moe_ffn", "moe_context",
           "current_moe_mesh"]

_moe_stack: list = []


@contextlib.contextmanager
def moe_context(mesh, axis: str = "ep", comm: Comm | None = None):
    """Marks the mesh whose ranks share the batch (dp, sp) and the
    expert bank (`axis`, tp) for ``moe_ffn`` (``models/gpt.py`` enters
    it through the hybrid step); `comm` times the collectives under
    "ep". The mesh's joint groups are made on first use: every rank
    enters the context in the same order."""
    _moe_stack.append((mesh, axis, comm or Comm()))
    try:
        yield
    finally:
        _moe_stack.pop()


def current_moe_mesh():
    """(mesh, axis) of the innermost ``moe_context``, or None."""
    return _moe_stack[-1][:2] if _moe_stack else None


@dataclasses.dataclass
class _Place:
    """A rank's share of the tokens and of the experts."""
    tokens: object      # (dp, sp) group, dp-major
    n_dp: int
    n_sp: int
    dp_rank: int
    sp_rank: int
    experts: TP         # (ep, tp): the tokens' cotangent
    ep: TP              # the combine's sum, the gates' cotangent
    tp: TP              # the down projection's sum
    ep_rank: int
    comm: Comm


def _place():
    if not _moe_stack:
        return None
    mesh, axis, comm = _moe_stack[-1]

    def size(a):
        return mesh.axis_size(a) if a in mesh.axis_names else 1

    def coord(a):
        return mesh.coord(a) if a in mesh.axis_names else 0

    def pair(axes, kind):
        g = mesh.joint_group(axes)
        return TP(g, 0, group_size(g), comm, kind)

    return _Place(tokens=mesh.joint_group(("dp", "sp")), n_dp=size("dp"),
                  n_sp=size("sp"), dp_rank=coord("dp"), sp_rank=coord("sp"),
                  experts=pair((axis, "tp"), "ep"), ep=pair((axis,), "ep"),
                  tp=pair(("tp",), "ep"), ep_rank=coord(axis), comm=comm)


class _CopyTokens(torch.autograd.Function):
    """(tokens, gates) unchanged; in the backward the tokens' cotangent
    summed over (ep, tp), then the gates' over ep (one node, so every
    rank issues the two sums in one order)."""

    @staticmethod
    def forward(ctx, xf, g, place):
        ctx.place = place
        return xf.view_as(xf), g.view_as(g)

    @staticmethod
    def backward(ctx, dx, dg):
        p = ctx.place
        return (p.experts.all_reduce(dx.contiguous().clone()),
                p.ep.all_reduce(dg.contiguous().clone()), None)


def moe_capacity(n_tokens: int, n_experts: int,
                 capacity_factor: float = 1.25, top_k: int = 1,
                 multiple_of: int = 8) -> int:
    """Static per-expert buffer length C: tokens beyond it are dropped
    (their residual connection still carries them forward)."""
    c = math.ceil(capacity_factor * top_k * n_tokens / n_experts)
    return max(multiple_of, multiple_of * math.ceil(c / multiple_of))


def _route(logits, top_k: int, capacity: int, rows: int = 1, place=None):
    """The router of ``topk_gating`` in indexed form. logits [N, E]
    (this rank's tokens, `rows` rows of N / rows each). Returns
    (experts, slots, keep, gates, aux): the first four [top_k, N] (the
    k-th choice's expert, its slot in that expert's buffer, whether it
    fits under `capacity`, its normalised gate), aux the load-balance
    loss (this rank's share under a `place`)."""
    N, E = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    experts, masks, gates = [], [], []
    remaining = probs.detach()
    for _ in range(top_k):
        idx = remaining.argmax(-1)
        m = F.one_hot(idx, E).to(torch.float32)
        experts.append(idx)
        masks.append(m)
        gates.append((probs * m).sum(-1))
        remaining = remaining * (1.0 - m)
    # tokens a (row, expert) a round, then the counts of every rank's
    # rows in global order: dp rank, row, sp rank
    per = N // rows
    counts = torch.stack([m.view(rows, per, E).sum(1) for m in masks])
    n_dp, n_sp = (place.n_dp, place.n_sp) if place else (1, 1)
    if place is not None and n_dp * n_sp > 1:
        from ..distributed.collective import all_gather
        with place.comm.timed("ep", counts):
            parts = all_gather([], counts, group=place.tokens)
        chunks = torch.stack(parts).view(n_dp, n_sp, top_k, rows, E) \
            .permute(2, 0, 3, 1, 4).reshape(top_k, -1, E)
        mine = ((place.dp_rank * rows + torch.arange(rows)) * n_sp
                + place.sp_rank).to(counts.device)
    else:
        chunks = counts
        mine = torch.arange(rows, device=counts.device)
    total = chunks.sum(1)                               # [K, E]
    start = (torch.cumsum(chunks, 1) - chunks)[:, mine]  # [K, rows, E]
    n_global = N * n_dp * n_sp
    f = total[0] / n_global
    p = probs.sum(0) / n_global * n_dp
    aux = E * torch.sum(f * p)
    denom = sum(gates)
    gates = [g / torch.clamp(denom, min=1e-9) for g in gates]
    slots, keep = [], []
    offset = torch.zeros(E, dtype=torch.float32, device=logits.device)
    for k, m in enumerate(masks):
        pos = (torch.cumsum(m.view(rows, per, E), 1) - 1.0
               + start[k][:, None, :]).reshape(N, E) + offset
        offset = offset + total[k]
        pos = (pos * m).sum(-1)
        slots.append(pos.long())
        keep.append(pos < capacity)
    return (torch.stack(experts), torch.stack(slots), torch.stack(keep),
            torch.stack(gates), aux)


def topk_gating(logits, top_k: int, capacity: int):
    """GShard-style router (the reference's outputs).

    Args:
      logits: [N, E] router scores (any float dtype; softmax in fp32).
      top_k: experts per token (1 = Switch, 2 = GShard).
      capacity: static per-expert buffer length C.

    Returns:
      dispatch: [N, E, C] 0/1 float32 — token n occupies slot c of
        expert e.
      combine: [N, E, C] float32 — dispatch weighted by the normalised
        gates.
      aux: scalar load-balance loss (Switch eq. 4: E * sum_e f_e P_e),
        differentiable through the router probabilities.
    """
    N, E = logits.shape
    experts, slots, keep, gates, aux = _route(logits, top_k, capacity)
    dispatch = torch.zeros((N, E, capacity), dtype=torch.float32,
                           device=logits.device)
    combine = torch.zeros_like(dispatch)
    for k in range(top_k):
        d = (F.one_hot(experts[k], E).to(torch.float32)
             * keep[k, :, None])[:, :, None] * F.one_hot(
                 slots[k].clamp(0, capacity - 1) * keep[k], capacity
             ).to(torch.float32)[:, None, :]
        dispatch = dispatch + d
        combine = combine + d * gates[k][:, None, None]
    return dispatch, combine, aux


def moe_ffn(x, wg, we_up, be_up, we_down, be_down, *,
            capacity_factor: float = 1.25, top_k: int = 1, act=None):
    """MoE feed-forward: route, dispatch, expert FFN, combine.

    Args:
      x: [B, T, D] (or [N, D]) activations (a rank's rows and columns
        inside ``moe_context``).
      wg: [D, E] router weights.
      we_up/be_up: [E, D, F] / [E, F] expert up-projections (a rank's
        E/ep experts, F/tp columns, inside ``moe_context``).
      we_down/be_down: [E, F, D] / [E, D] expert down-projections.

    Returns (y, aux): y shaped like x; aux the load-balance scalar."""
    if act is None:
        act = gelu_tanh
    shape = x.shape
    D = shape[-1]
    xf = x.reshape(-1, D)
    N = xf.shape[0]
    rows = shape[0] if x.dim() == 3 else 1
    place = _place()
    E_loc = we_up.shape[0]
    E = wg.shape[-1]
    n_tok = place.n_dp * place.n_sp if place else 1
    C = moe_capacity(N * n_tok, E, capacity_factor, top_k)
    logits = xf.float() @ wg.float()
    experts, slots, keep, gates, aux = _route(logits, top_k, C, rows, place)

    dt = x.dtype
    g = gates.t().to(dt)                                  # [N, K]
    if place is not None and place.experts.size > 1:
        xf, g = _CopyTokens.apply(xf, g, place)
    e0 = place.ep_rank * E_loc if place else 0
    local = keep & (experts >= e0) & (experts < e0 + E_loc)
    k_i, tok = local.nonzero(as_tuple=True)
    slot = (experts[k_i, tok] - e0) * C + slots[k_i, tok]
    xin = torch.zeros((E_loc * C, D), dtype=dt, device=x.device) \
        .index_copy(0, slot, xf[tok])
    h = act(torch.bmm(xin.view(E_loc, C, D), we_up.to(dt))
            + be_up.to(dt)[:, None, :])
    if place is not None and place.tp.size > 1:
        out = reduce_from_tp(torch.bmm(h.float(), we_down.float()),
                             place.tp).to(dt)
    else:
        out = torch.bmm(h, we_down.to(dt))
    out = out + be_down.to(dt)[:, None, :]
    terms = out.view(E_loc * C, D)[slot].float() * g[tok, k_i].float()[:, None]
    y = torch.zeros((N, D), dtype=torch.float32, device=x.device) \
        .index_add(0, tok, terms)
    if place is not None and place.ep.size > 1:
        y = reduce_from_tp(y, place.ep)
    return y.to(dt).reshape(shape), aux

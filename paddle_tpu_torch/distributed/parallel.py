"""DataParallel for eager models (counterpart of
``paddle_tpu/distributed/parallel.py``).

Gradient sync is an all-reduce of the gradients after the backward,
fused into flat buckets of about ``comm_buffer_size`` MB, split where
the dtype changes, one ``all_reduce(SUM)`` a bucket
(``all_reduce_buckets``; the reference's coalesced all-reduce,
dygraph/parallel.py:449). ``jit.TrainStep(mesh=)`` and the static
executor's data-parallel programs use the same buckets. With one
process the wrapper is the identity.
"""
from __future__ import annotations

import torch

from ..nn.layers_common import Layer
from .collective import ReduceOp, _group, all_reduce, broadcast
from .env import get_world_size

__all__ = ["DataParallel", "scale_loss", "bucket_indices",
           "all_reduce_buckets", "broadcast_tensors"]


def scale_loss(loss):
    n = get_world_size()
    if n <= 1:
        return loss
    return loss / n


def bucket_indices(tensors, budget_bytes: int) -> list[list[int]]:
    """The buckets of `tensors` in order: a new bucket starts where the
    dtype changes or the next tensor would take the bucket past
    `budget_bytes` (a tensor larger than the budget is a bucket alone)."""
    buckets, cur, cur_bytes, cur_dtype = [], [], 0, None
    for i, t in enumerate(tensors):
        nbytes = t.numel() * t.element_size()
        if cur and (t.dtype != cur_dtype or
                    cur_bytes + nbytes > budget_bytes):
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes
        cur_dtype = t.dtype
    if cur:
        buckets.append(cur)
    return buckets


def all_reduce_buckets(tensors, budget_bytes: int = 25 << 20, group=None,
                       scale: float = 1.0) -> list[list[int]]:
    """Sum `tensors` in place over `group` (see collective._group), one
    flat all-reduce a bucket, then multiply by `scale`; returns the
    buckets. The identity (scale aside) over a group of one rank."""
    g, n = _group(group)
    buckets = bucket_indices(tensors, budget_bytes)
    if n == 1:
        if scale != 1.0:
            for t in tensors:
                t.mul_(scale)
        return buckets
    for idx in buckets:
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        all_reduce(flat, ReduceOp.SUM, group=g)
        if scale != 1.0:
            flat.mul_(scale)
        off = 0
        for i in idx:
            t = tensors[i]
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()
    return buckets


def broadcast_tensors(tensors, src: int = 0, group=None):
    """Every rank takes rank `src`'s values of `tensors`, in place."""
    g, n = _group(group)
    if n > 1:
        for t in tensors:
            broadcast(t, src, group=g)


class DataParallel(Layer):
    """Wraps a layer: the forward is the layer's; at construction every
    rank takes rank 0's parameters and buffers; after the backward
    ``apply_collective_grads()`` sums the gradients over the ranks
    (``scale_loss`` divides the loss by their number first, as in the
    reference)."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False):
        super().__init__()
        self._layers = layers
        self._comm_buffer_bytes = int(comm_buffer_size * (1 << 20))
        with torch.no_grad():
            broadcast_tensors([*layers.parameters(), *layers.buffers()])

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        return scale_loss(loss)

    def apply_collective_grads(self):
        """All-reduce (sum) the gradients in flat buckets of about
        comm_buffer_size MB, split by dtype."""
        if get_world_size() <= 1:
            return
        grads = [p.grad for p in self._layers.parameters()
                 if p.grad is not None]
        with torch.no_grad():
            all_reduce_buckets(grads, self._comm_buffer_bytes)

    def parameters(self, include_sublayers=True):
        return self._layers.parameters(include_sublayers)

    def named_parameters(self, prefix="", include_sublayers=True):
        return self._layers.named_parameters(prefix, include_sublayers)

    def state_dict(self, *a, **kw):
        return self._layers.state_dict(*a, **kw)

    def set_state_dict(self, *a, **kw):
        return self._layers.load_state_dict(*a, **kw)

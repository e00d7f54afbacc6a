"""Row-sharded embedding tables over a mesh axis (counterpart of
``paddle_tpu/parallel/embedding.py``).

The reference keeps a large table on the devices, its rows cut over a
mesh axis, and turns the lookup into a collective: each shard owns a
contiguous row range [i V/n, (i+1) V/n), gathers its hits, zeros the
misses, and the partial rows are summed over the axis (one all-reduce
of [..., D] instead of a parameter-server pull); the table's gradient
is the local scatter-add of the cotangent (the push). The port runs one
process per rank, each holding its rows; the sum is the conjugate
function of the tensor-parallel layers (forward all-reduce, backward
identity), so the replicated cotangent reaches every shard whole.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .comm import Comm, group_size
from .tensor_parallel import TP, reduce_from_tp

__all__ = ["ShardedEmbedding", "sharded_embedding_lookup", "shard_rows"]


def shard_rows(table, mesh, axis: str = "mp"):
    """This rank's rows [i V/n, (i+1) V/n) of a whole [V, D] table
    (numpy or a tensor) cut over `axis` (n ranks, this rank i)."""
    n = mesh.axis_size(axis)
    V = table.shape[0]
    if V % n:
        raise ValueError(f"vocab {V} not divisible by {axis}={n}")
    per = V // n
    i = mesh.coord(axis)
    return table[i * per:(i + 1) * per]


def sharded_embedding_lookup(table, ids, mesh, axis: str = "mp",
                             comm: Comm | None = None):
    """table: this rank's [V/n, D] rows of a [V, D] table cut over
    `axis` (n ranks; ``shard_rows``); ids: int [...] (the same on every
    rank of the axis). Returns the [..., D] embeddings, the same on
    those ranks.

    Differentiable: the table's gradient is the scatter-add of the
    cotangent into this rank's rows (its hits). `comm` times the sum
    under "mp"."""
    n = mesh.axis_size(axis)
    per = table.shape[0]
    ids = torch.as_tensor(ids, device=table.device).long()
    if n == 1:
        return F.embedding(ids, table)
    loc = ids - mesh.coord(axis) * per
    hit = (loc >= 0) & (loc < per)
    rows = F.embedding(loc.clamp(0, per - 1), table) \
        * hit[..., None].to(table.dtype)
    group = mesh.group(axis)
    return reduce_from_tp(rows, TP(group, mesh.coord(axis),
                                   group_size(group), comm or Comm(), axis))


class ShardedEmbedding:
    """Row-sharded table + lookup. ``spec`` gives the layout (rows over
    `axis`), so a trainer shards the optimizer state alike; ``table``
    is this rank's rows, drawn from the reference's whole-table init
    (``RandomState(seed).normal(0, init_std, (V, D))``)."""

    def __init__(self, vocab_size: int, dim: int, mesh, axis: str = "mp",
                 init_std: float = 0.01, seed: int = 0,
                 dtype=torch.float32, device="cpu"):
        self.vocab_size, self.dim = vocab_size, dim
        self.mesh, self.axis = mesh, axis
        self.spec = (axis, None)
        rng = np.random.RandomState(seed)
        full = rng.normal(0, init_std, (vocab_size, dim)).astype(np.float32)
        self.table = torch.as_tensor(shard_rows(full, mesh, axis).copy()) \
            .to(device=device, dtype=dtype)

    def __call__(self, ids, table=None):
        return sharded_embedding_lookup(
            self.table if table is None else table, ids, self.mesh,
            self.axis)

"""SelectedRows: the sparse-rows gradient (counterpart of
``paddle_tpu/fluid/selected_rows.py``, the reference's
framework/selected_rows.h).

A row index ``rows`` (int64, [N]) and the rows' values ([N, D...]) of a
table of ``height`` rows: what an ``is_sparse`` lookup's gradient is,
so that the optimizer touches only the rows the batch looked up. Both
tensors live on one device, the values'. Duplicate row ids are legal
and accumulate: ``to_dense`` is a scatter-add; ``merged`` folds the
duplicates into one row each, in ascending row order.
"""
from __future__ import annotations

import torch

__all__ = ["SelectedRows"]


class SelectedRows:
    def __init__(self, rows, values, height: int):
        values = torch.as_tensor(values)
        self.rows = torch.as_tensor(rows, device=values.device).long()
        self.values = values
        self.height = int(height)

    @property
    def shape(self):
        return (self.height,) + tuple(self.values.shape[1:])

    @property
    def dtype(self):
        return self.values.dtype

    def to(self, device):
        return SelectedRows(self.rows.to(device), self.values.to(device),
                            self.height)

    def to_dense(self) -> torch.Tensor:
        z = torch.zeros(self.shape, dtype=self.values.dtype,
                        device=self.values.device)
        return z.index_add_(0, self.rows, self.values)

    def merged(self) -> "SelectedRows":
        """One row a distinct id, the duplicates' values summed, rows in
        ascending order."""
        uniq, inv = torch.unique(self.rows, sorted=True, return_inverse=True)
        out = torch.zeros((uniq.numel(),) + tuple(self.values.shape[1:]),
                          dtype=self.values.dtype, device=self.values.device)
        return SelectedRows(uniq, out.index_add_(0, inv, self.values),
                            self.height)

    def __repr__(self):
        return (f"SelectedRows(height={self.height}, "
                f"nnz_rows={self.rows.shape[0]}, dim={self.shape[1:]})")

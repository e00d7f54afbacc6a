"""In-graph metric ops (counterpart of
``paddle_tpu/fluid/ops/metric_ops.py``): accuracy."""
from __future__ import annotations

import torch

from ..registry import register
from .common import x


def _acc_infer(op):
    for name in op.output("Accuracy") + op.output("Correct") + op.output("Total"):
        op.block.create_var(name=name, shape=(1,), dtype="float32")


@register("accuracy", grad=None, infer_shape=_acc_infer)
def _accuracy(ctx, ins, attrs):
    """Inputs: Out (topk values), Indices (topk indices), Label."""
    idx, label = x(ins, "Indices"), x(ins, "Label")
    lab = label.reshape(label.shape[0], -1)[:, :1].long()
    hit = (idx.reshape(idx.shape[0], -1) == lab).any(dim=1)
    total = idx.shape[0]
    correct = hit.float().sum()
    return {"Accuracy": [(correct / total).reshape(1)],
            "Correct": [correct.reshape(1).int()],
            "Total": [torch.full((1,), total, dtype=torch.int32,
                                 device=idx.device)]}

"""In-graph metric ops (counterpart of
``paddle_tpu/fluid/ops/metric_ops.py``): accuracy and the streaming
auc."""
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


@register("auc", grad=None,
          attrs={"curve": "ROC", "num_thresholds": 4095, "slide_steps": 1})
def _auc(ctx, ins, attrs):
    """Streaming ROC AUC over `num_thresholds` + 1 bins, the bins'
    positive and negative counts carried in StatPos / StatNeg (the
    reference's operators/metrics/auc_op.cc)."""
    preds, label = x(ins, "Predict"), x(ins, "Label")
    stat_pos, stat_neg = x(ins, "StatPos"), x(ins, "StatNeg")
    nt = attrs["num_thresholds"]
    p1 = preds[:, 1] if preds.dim() == 2 and preds.shape[1] == 2 else \
        preds.reshape(-1)
    lab = label.reshape(-1).bool()
    bins = (p1 * nt).to(torch.int32).clamp(0, nt).long()
    cnt = stat_pos.reshape(-1)
    pos = torch.zeros(nt + 1, dtype=cnt.dtype, device=cnt.device) \
        .index_add(0, bins, lab.to(cnt.dtype))
    neg = torch.zeros(nt + 1, dtype=cnt.dtype, device=cnt.device) \
        .index_add(0, bins, (~lab).to(cnt.dtype))
    new_pos = cnt + pos
    new_neg = stat_neg.reshape(-1) + neg
    # the trapezoid rule over descending thresholds
    tp = torch.cumsum(new_pos.flip(0), 0)
    fp = torch.cumsum(new_neg.flip(0), 0)
    tot_pos, tot_neg = tp[-1], fp[-1]
    zero = tp.new_zeros(1)
    tp_prev = torch.cat([zero, tp[:-1]])
    fp_prev = torch.cat([zero, fp[:-1]])
    area = ((fp - fp_prev) * (tp + tp_prev)).float().sum() / 2.0
    denom = torch.clamp(tot_pos * tot_neg, min=1).float()
    auc = torch.where((tot_pos > 0) & (tot_neg > 0), area / denom,
                      torch.zeros_like(area))
    return {"AUC": [auc.reshape(1)],
            "StatPosOut": [new_pos.reshape(stat_pos.shape)],
            "StatNegOut": [new_neg.reshape(stat_neg.shape)]}

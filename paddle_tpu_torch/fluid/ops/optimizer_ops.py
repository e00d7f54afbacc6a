"""Optimizer updates (counterpart of the ``adam`` and ``adamw`` ops of
``paddle_tpu/fluid/ops/optimizer_ops.py``), as plain functions on
tensors, and the registered ``adam`` op of the static graph over them.

Paddle's Adam is not ``torch.optim.Adam``/``AdamW``; the port keeps
Paddle's formula:

  * eps sits outside the bias correction:
        lr_t = lr * sqrt(1 - beta2_pow) / (1 - beta1_pow)
        p   -= lr_t * m1 / (sqrt(m2) + eps)
    (torch divides m2's correction inside the square root and adds eps
    after it);
  * AdamW decays first, ``p *= 1 - lr * coeff * lr_ratio``, then takes
    the Adam step (torch decays by ``lr * weight_decay`` with its own
    bias-corrected step).

Where the reference returns new arrays (and donates the old buffers),
these update ``param``, ``moment1`` and ``moment2`` IN PLACE and return
the new beta powers. The ``adam`` op does the same to the scope's
tensors: its ParamOut/Moment1Out/Moment2Out are its inputs, updated.
"""
from __future__ import annotations

import torch

from ..registry import register
from .common import x

__all__ = ["adam", "adamw"]


def adam(param, grad, moment1, moment2, beta1_pow, beta2_pow, lr,
         beta1=0.9, beta2=0.999, epsilon=1e-8):
    """One Adam step in place. ``moment1``/``moment2`` are float32 like
    the reference's; ``beta1_pow``/``beta2_pow`` are the float32 powers
    before this step; ``lr`` a float or float32 tensor. Returns
    (beta1_pow * beta1, beta2_pow * beta2)."""
    g = grad.float()
    moment1.mul_(beta1).add_(g, alpha=1 - beta1)
    moment2.mul_(beta2).addcmul_(g, g, value=1 - beta2)
    b1p, b2p = beta1_pow * beta1, beta2_pow * beta2
    lr_t = lr * torch.sqrt(1 - b2p.reshape(())) / (1 - b1p.reshape(()))
    step = (moment1 / (torch.sqrt(moment2) + epsilon)).to(param.dtype)
    param.sub_(lr_t * step)
    return b1p, b2p


def adamw(param, grad, moment1, moment2, beta1_pow, beta2_pow, lr,
          beta1=0.9, beta2=0.999, epsilon=1e-8, coeff=0.01, lr_ratio=1.0,
          with_decay=True):
    """Decoupled weight decay, then :func:`adam`, in place; returns the
    new beta powers."""
    if with_decay:
        param.mul_(1.0 - lr * coeff * lr_ratio)
    return adam(param, grad, moment1, moment2, beta1_pow, beta2_pow, lr,
                beta1, beta2, epsilon)


@register("adam", grad=None,
          attrs={"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8,
                 "lazy_mode": False, "min_row_size_to_use_multithread": 1000})
def _adam_op(ctx, ins, attrs):
    p, g = x(ins, "Param"), x(ins, "Grad")
    if not isinstance(g, torch.Tensor):
        raise NotImplementedError(
            "adam on a SelectedRows gradient comes with the sparse ops "
            "(ROADMAP.md A, item 11)")
    m1, m2 = x(ins, "Moment1"), x(ins, "Moment2")
    b1t, b2t = x(ins, "Beta1Tensor"), x(ins, "Beta2Tensor")
    b1 = attrs["beta1"] if b1t is None else float(b1t.reshape(()))
    b2 = attrs["beta2"] if b2t is None else float(b2t.reshape(()))
    b1pn, b2pn = adam(p, g, m1, m2, x(ins, "Beta1Pow"), x(ins, "Beta2Pow"),
                      x(ins, "LearningRate").reshape(()), b1, b2,
                      attrs["epsilon"])
    return {"ParamOut": [p], "Moment1Out": [m1], "Moment2Out": [m2],
            "Beta1PowOut": [b1pn], "Beta2PowOut": [b2pn]}

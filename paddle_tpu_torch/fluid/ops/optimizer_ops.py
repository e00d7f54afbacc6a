"""Optimizer updates (counterpart of the ``adam`` and ``adamw`` ops of
``paddle_tpu/fluid/ops/optimizer_ops.py``), as plain functions on
tensors.

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
the new beta powers.
"""
from __future__ import annotations

import torch

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

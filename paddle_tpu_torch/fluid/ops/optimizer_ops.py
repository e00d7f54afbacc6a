"""Optimizer updates (counterpart of the ``sgd``, ``momentum``, ``adam``
and ``adamw`` ops of ``paddle_tpu/fluid/ops/optimizer_ops.py``), as
plain functions on tensors, and the registered ``sgd``, ``momentum`` and
``adam`` ops of the static graph over them.

Momentum is Paddle's: ``v = mu * v + g``, then ``p -= lr * v`` (or,
with Nesterov, ``p -= (g + mu * v) * lr``); ``l2_decay`` adds
``coeff * p`` to g first. torch.optim.SGD's dampening and weight decay
are not used.

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
these update ``param`` and its accumulators IN PLACE (Adam returns the
new beta powers). The ops do the same to the scope's tensors: their
ParamOut, VelocityOut, Moment1Out and Moment2Out are their inputs,
updated.
"""
from __future__ import annotations

import torch

from ..registry import register
from .common import x

__all__ = ["sgd", "momentum", "adam", "adamw"]

_SPARSE = ("{} on a SelectedRows gradient comes with the sparse ops "
           "(ROADMAP.md A, item 11)")


def _dense(op_type, g):
    if not isinstance(g, torch.Tensor):
        raise NotImplementedError(_SPARSE.format(op_type))
    return g


def sgd(param, grad, lr):
    """p -= lr * g, in place."""
    param.sub_(lr * grad.to(param.dtype))


def momentum(param, grad, velocity, lr, mu=0.9, use_nesterov=False,
             regularization_method="", regularization_coeff=0.0):
    """One momentum step in place: ``velocity`` (float32, like the
    reference's) becomes mu * v + g, then p -= lr * v, or
    p -= (g + mu * v) * lr with Nesterov. ``l2_decay`` adds
    ``regularization_coeff * p`` to g first."""
    if regularization_method == "l2_decay":
        grad = grad + regularization_coeff * param
    velocity.mul_(mu).add_(grad)
    if use_nesterov:
        param.sub_((grad + mu * velocity) * lr)
    else:
        param.sub_(lr * velocity)


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


@register("sgd", grad=None, no_grad_slots=("Param", "Grad", "LearningRate"))
def _sgd_op(ctx, ins, attrs):
    p = x(ins, "Param")
    sgd(p, _dense("sgd", x(ins, "Grad")), x(ins, "LearningRate").reshape(()))
    return {"ParamOut": [p]}


@register("momentum", grad=None, attrs={"mu": 0.9, "use_nesterov": False,
                                        "regularization_method": "",
                                        "regularization_coeff": 0.0})
def _momentum_op(ctx, ins, attrs):
    p, v = x(ins, "Param"), x(ins, "Velocity")
    momentum(p, _dense("momentum", x(ins, "Grad")), v,
             x(ins, "LearningRate").reshape(()), attrs["mu"],
             attrs["use_nesterov"], attrs["regularization_method"],
             attrs["regularization_coeff"])
    return {"ParamOut": [p], "VelocityOut": [v]}


@register("adam", grad=None,
          attrs={"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8,
                 "lazy_mode": False, "min_row_size_to_use_multithread": 1000})
def _adam_op(ctx, ins, attrs):
    p, g = x(ins, "Param"), _dense("adam", x(ins, "Grad"))
    m1, m2 = x(ins, "Moment1"), x(ins, "Moment2")
    b1t, b2t = x(ins, "Beta1Tensor"), x(ins, "Beta2Tensor")
    b1 = attrs["beta1"] if b1t is None else float(b1t.reshape(()))
    b2 = attrs["beta2"] if b2t is None else float(b2t.reshape(()))
    b1pn, b2pn = adam(p, g, m1, m2, x(ins, "Beta1Pow"), x(ins, "Beta2Pow"),
                      x(ins, "LearningRate").reshape(()), b1, b2,
                      attrs["epsilon"])
    return {"ParamOut": [p], "Moment1Out": [m1], "Moment2Out": [m2],
            "Beta1PowOut": [b1pn], "Beta2PowOut": [b2pn]}

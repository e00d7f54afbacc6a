"""Optimizer updates and gradient utilities (counterpart of
``paddle_tpu/fluid/ops/optimizer_ops.py``): sgd, momentum, adam, adamw
and lamb as plain functions on tensors, which the train steps call, and
every update op of the reference module registered for the static
graph: those five over the functions, and adamax, adagrad, adadelta,
rmsprop, ftrl, dpsgd, decayed_adagrad, lars_momentum, dgc_momentum and
localsgd_sync, with the utilities clip_by_norm, lerp,
check_finite_and_unscale, update_loss_scaling, coalesce_tensor and
average_accumulates.

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

Lamb is the reference's: bias correction with the beta powers after
the step, r = m^ / (sqrt(v^) + eps) + wd * p, and the trust ratio
||p|| / ||r|| (1 where either norm is 0).

Where the reference returns new arrays (and donates the old buffers),
sgd, momentum, adam, adamw and lamb update ``param`` and its
accumulators IN PLACE (adam and lamb return the new beta powers). Their
ops do the same to the scope's tensors: their ParamOut, VelocityOut,
Moment1Out and Moment2Out are their inputs, updated. The other update
ops return new tensors, which the executor writes back to the scope.

A SelectedRows gradient (an ``is_sparse`` lookup's,
``fluid/selected_rows.py``) updates as the reference's does: sgd
scatter-adds ``-lr * rows`` into the looked-up rows alone; momentum
decays the whole velocity, scatter-adds the rows, then steps the whole
parameter (with Nesterov, ``-lr * mu * v`` everywhere and ``-lr * g``
on the rows); adam (and adamw after its decay) takes the dense step on
the scattered gradient, or with ``lazy_mode`` merges the duplicate rows
first and updates the moments and the parameter on each distinct row
once. The other update ops raise on a SelectedRows gradient, as the
reference's fail on one.

``localsgd_sync`` averages over the executor's data-parallel group when
the run has one, and is the identity otherwise, as the reference's is
without a "dp" axis.
"""
from __future__ import annotations

import torch

from ..registry import lookup, register, same_shape_as
from ..selected_rows import SelectedRows
from .common import x

__all__ = ["sgd", "momentum", "adam", "adamw", "lamb"]

_SPARSE = ("{} takes a dense gradient, not a SelectedRows one (the "
           "reference's has no sparse rule either): sgd, momentum, adam and "
           "adamw update from sparse rows")


def _dense(op_type, g):
    if not isinstance(g, torch.Tensor):
        raise NotImplementedError(_SPARSE.format(op_type))
    return g


def _adam_lazy(param, grad, moment1, moment2, beta1_pow, beta2_pow, lr,
               beta1, beta2, epsilon):
    """Adam's lazy_mode on a SelectedRows gradient, in place: the
    duplicate rows merged, then the moments and the parameter of each
    distinct row updated once; the other rows untouched. Returns the
    new beta powers."""
    g = grad.merged()
    rows, gv = g.rows, g.values.float()
    m1n = beta1 * moment1[rows] + (1 - beta1) * gv
    m2n = beta2 * moment2[rows] + (1 - beta2) * torch.square(gv)
    b1p, b2p = beta1_pow * beta1, beta2_pow * beta2
    lr_t = lr * torch.sqrt(1 - b2p.reshape(())) / (1 - b1p.reshape(()))
    upd = (lr_t * m1n / (torch.sqrt(m2n) + epsilon)).to(param.dtype)
    param.index_add_(0, rows, -upd)
    moment1[rows] = m1n
    moment2[rows] = m2n
    return b1p, b2p


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


def lamb(param, grad, moment1, moment2, beta1_pow, beta2_pow, lr,
         beta1=0.9, beta2=0.999, epsilon=1e-6, weight_decay=0.01):
    """One Lamb step in place (moments float32, like Adam's); returns
    the new beta powers."""
    g = grad.float()
    moment1.mul_(beta1).add_(g, alpha=1 - beta1)
    moment2.mul_(beta2).addcmul_(g, g, value=1 - beta2)
    b1p, b2p = beta1_pow * beta1, beta2_pow * beta2
    mhat = moment1 / (1 - b1p.reshape(()))
    vhat = moment2 / (1 - b2p.reshape(()))
    p32 = param.float()
    r = mhat / (torch.sqrt(vhat) + epsilon) + weight_decay * p32
    p_norm = torch.linalg.vector_norm(p32)
    r_norm = torch.linalg.vector_norm(r)
    trust = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm,
                        torch.ones_like(p_norm))
    param.sub_((lr * trust * r).to(param.dtype))
    return b1p, b2p


@register("sgd", grad=None, no_grad_slots=("Param", "Grad", "LearningRate"))
def _sgd_op(ctx, ins, attrs):
    p, g = x(ins, "Param"), x(ins, "Grad")
    lr = x(ins, "LearningRate").reshape(())
    if isinstance(g, SelectedRows):
        p.index_add_(0, g.rows, (-lr * g.values).to(p.dtype))
    else:
        sgd(p, g, lr)
    return {"ParamOut": [p]}


@register("momentum", grad=None, attrs={"mu": 0.9, "use_nesterov": False,
                                        "regularization_method": "",
                                        "regularization_coeff": 0.0})
def _momentum_op(ctx, ins, attrs):
    p, v, g = x(ins, "Param"), x(ins, "Velocity"), x(ins, "Grad")
    lr, mu = x(ins, "LearningRate").reshape(()), attrs["mu"]
    if isinstance(g, SelectedRows):
        if attrs["regularization_method"] == "l2_decay":
            raise NotImplementedError(
                "l2_decay with a SelectedRows momentum gradient: densify "
                "the gradient or decay on the dense path (the reference "
                "raises too)")
        # the dense rule with g zero off the rows
        v.mul_(mu).index_add_(0, g.rows, g.values.to(v.dtype))
        if attrs["use_nesterov"]:
            p.sub_(lr * mu * v).index_add_(0, g.rows,
                                            (-lr * g.values).to(p.dtype))
        else:
            p.sub_(lr * v)
    else:
        momentum(p, g, v, lr, mu, attrs["use_nesterov"],
                 attrs["regularization_method"],
                 attrs["regularization_coeff"])
    return {"ParamOut": [p], "VelocityOut": [v]}


@register("adam", grad=None,
          attrs={"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8,
                 "lazy_mode": False, "min_row_size_to_use_multithread": 1000})
def _adam_op(ctx, ins, attrs):
    p, g = x(ins, "Param"), x(ins, "Grad")
    m1, m2 = x(ins, "Moment1"), x(ins, "Moment2")
    b1t, b2t = x(ins, "Beta1Tensor"), x(ins, "Beta2Tensor")
    b1 = attrs["beta1"] if b1t is None else float(b1t.reshape(()))
    b2 = attrs["beta2"] if b2t is None else float(b2t.reshape(()))
    update = adam
    if isinstance(g, SelectedRows):
        # lazy_mode touches the rows alone; otherwise Adam decays every
        # moment, so the rows are scattered into a dense gradient
        if attrs.get("lazy_mode"):
            update = _adam_lazy
        else:
            g = g.to_dense()
    b1pn, b2pn = update(p, g, m1, m2, x(ins, "Beta1Pow"),
                        x(ins, "Beta2Pow"),
                        x(ins, "LearningRate").reshape(()), b1, b2,
                        attrs["epsilon"])
    return {"ParamOut": [p], "Moment1Out": [m1], "Moment2Out": [m2],
            "Beta1PowOut": [b1pn], "Beta2PowOut": [b2pn]}


def _lr(ins):
    return x(ins, "LearningRate").reshape(())


def _pg(op_type, ins):
    return x(ins, "Param"), _dense(op_type, x(ins, "Grad"))


@register("adamw", grad=None,
          attrs={"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8,
                 "coeff": 0.01, "lr_ratio": 1.0, "with_decay": True,
                 "lazy_mode": False})
def _adamw_op(ctx, ins, attrs):
    p, g = x(ins, "Param"), x(ins, "Grad")
    if isinstance(g, SelectedRows):
        # the decay, then adam's sparse rules, as the reference's
        if attrs.get("with_decay", True):
            p.mul_(1.0 - _lr(ins) * attrs["coeff"]
                   * attrs.get("lr_ratio", 1.0))
        return _adam_op(ctx, ins, attrs)
    m1, m2 = x(ins, "Moment1"), x(ins, "Moment2")
    b1pn, b2pn = adamw(p, g, m1, m2, x(ins, "Beta1Pow"), x(ins, "Beta2Pow"),
                       _lr(ins), attrs["beta1"], attrs["beta2"],
                       attrs["epsilon"], attrs["coeff"],
                       attrs.get("lr_ratio", 1.0),
                       attrs.get("with_decay", True))
    return {"ParamOut": [p], "Moment1Out": [m1], "Moment2Out": [m2],
            "Beta1PowOut": [b1pn], "Beta2PowOut": [b2pn]}


@register("lamb", grad=None,
          attrs={"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6,
                 "weight_decay": 0.01})
def _lamb_op(ctx, ins, attrs):
    p, g = x(ins, "Param"), _dense("lamb", x(ins, "Grad"))
    m1, m2 = x(ins, "Moment1"), x(ins, "Moment2")
    b1pn, b2pn = lamb(p, g, m1, m2, x(ins, "Beta1Pow"), x(ins, "Beta2Pow"),
                      _lr(ins), attrs["beta1"], attrs["beta2"],
                      attrs["epsilon"], attrs["weight_decay"])
    return {"ParamOut": [p], "Moment1Out": [m1], "Moment2Out": [m2],
            "Beta1PowOut": [b1pn], "Beta2PowOut": [b2pn]}



@register("adamax", grad=None,
          attrs={"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8})
def _adamax(ctx, ins, attrs):
    p, g = _pg("adamax", ins)
    m, inf = x(ins, "Moment"), x(ins, "InfNorm")
    b1, b2, eps = attrs["beta1"], attrs["beta2"], attrs["epsilon"]
    m_new = b1 * m + (1 - b1) * g
    inf_new = torch.maximum(b2 * inf, torch.abs(g))
    lr_t = _lr(ins) / (1 - x(ins, "Beta1Pow").reshape(()))
    return {"ParamOut": [p - lr_t * m_new / (inf_new + eps)],
            "MomentOut": [m_new], "InfNormOut": [inf_new]}


@register("adagrad", grad=None, attrs={"epsilon": 1e-6})
def _adagrad(ctx, ins, attrs):
    p, g = _pg("adagrad", ins)
    mom_new = x(ins, "Moment") + torch.square(g)
    return {"ParamOut": [p - _lr(ins) * g / (torch.sqrt(mom_new)
                                             + attrs["epsilon"])],
            "MomentOut": [mom_new]}


@register("adadelta", grad=None, attrs={"rho": 0.95, "epsilon": 1e-6})
def _adadelta(ctx, ins, attrs):
    p, g = _pg("adadelta", ins)
    avg_sq, avg_upd = x(ins, "AvgSquaredGrad"), x(ins, "AvgSquaredUpdate")
    rho, eps = attrs["rho"], attrs["epsilon"]
    sq = rho * avg_sq + (1 - rho) * torch.square(g)
    upd = g * torch.sqrt(avg_upd + eps) / torch.sqrt(sq + eps)
    upd_acc = rho * avg_upd + (1 - rho) * torch.square(upd)
    return {"ParamOut": [p - upd], "AvgSquaredGradOut": [sq],
            "AvgSquaredUpdateOut": [upd_acc]}


@register("rmsprop", grad=None,
          attrs={"epsilon": 1e-10, "decay": 0.9, "momentum": 0.0,
                 "centered": False})
def _rmsprop(ctx, ins, attrs):
    p, g = _pg("rmsprop", ins)
    ms, mom, mg = x(ins, "MeanSquare"), x(ins, "Moment"), x(ins, "MeanGrad")
    rho, eps, mu = attrs["decay"], attrs["epsilon"], attrs["momentum"]
    ms_new = rho * ms + (1 - rho) * torch.square(g)
    if attrs.get("centered"):
        mg_new = rho * mg + (1 - rho) * g
        denom = ms_new - torch.square(mg_new) + eps
    else:
        mg_new = mg
        denom = ms_new + eps
    mom_new = mu * mom + _lr(ins) * g / torch.sqrt(denom)
    outs = {"ParamOut": [p - mom_new], "MeanSquareOut": [ms_new],
            "MomentOut": [mom_new]}
    if mg is not None:
        outs["MeanGradOut"] = [mg_new]
    return outs


@register("ftrl", grad=None, attrs={"l1": 0.0, "l2": 0.0, "lr_power": -0.5})
def _ftrl(ctx, ins, attrs):
    p, g = _pg("ftrl", ins)
    sq, lin = x(ins, "SquaredAccumulator"), x(ins, "LinearAccumulator")
    lr = _lr(ins)
    l1, l2, lrp = attrs["l1"], attrs["l2"], attrs["lr_power"]
    new_sq = sq + torch.square(g)
    sigma = (new_sq ** -lrp - sq ** -lrp) / lr
    new_lin = lin + g - sigma * p
    pre = torch.clamp(new_lin, -l1, l1) - new_lin
    denom = new_sq ** -lrp / lr + 2 * l2
    return {"ParamOut": [pre / denom], "SquaredAccumOut": [new_sq],
            "LinearAccumOut": [new_lin]}


@register("dpsgd", grad=None, stochastic=True,
          attrs={"clip": 10.0, "batch_size": 16.0, "sigma": 1.0})
def _dpsgd(ctx, ins, attrs):
    p, g = _pg("dpsgd", ins)
    gn = torch.linalg.vector_norm(g)
    scale = torch.clamp(attrs["clip"] / torch.clamp(gn, min=1e-12), max=1.0)
    noise = torch.randn(g.shape, generator=ctx.generator(attrs),
                        device=g.device, dtype=g.dtype) \
        * attrs["sigma"] * attrs["clip"] / attrs["batch_size"]
    return {"ParamOut": [p - _lr(ins) * (g * scale + noise)]}


@register("decayed_adagrad", grad=None,
          attrs={"decay": 0.95, "epsilon": 1e-6})
def _decayed_adagrad(ctx, ins, attrs):
    p, g = _pg("decayed_adagrad", ins)
    mom_new = attrs["decay"] * x(ins, "Moment") \
        + (1 - attrs["decay"]) * torch.square(g)
    return {"ParamOut": [p - _lr(ins) * g / (torch.sqrt(mom_new)
                                             + attrs["epsilon"])],
            "MomentOut": [mom_new]}


@register("lars_momentum", grad=None,
          attrs={"mu": 0.9, "lars_coeff": 0.001,
                 "lars_weight_decay": 0.0005, "epsilon": 0.0})
def _lars_momentum(ctx, ins, attrs):
    """Layer-wise adaptive rate scaling: the local lr of a parameter
    scales with ||p|| / (||g|| + wd * ||p||)."""
    p, g = _pg("lars_momentum", ins)
    v, lr = x(ins, "Velocity"), _lr(ins)
    mu, coeff = attrs["mu"], attrs["lars_coeff"]
    wd, eps = attrs["lars_weight_decay"], attrs["epsilon"]
    g = g.float()
    p32 = p.float()
    p_norm = torch.linalg.vector_norm(p32)
    g_norm = torch.linalg.vector_norm(g)
    local_lr = torch.where((p_norm > 0) & (g_norm > 0),
                           lr * coeff * p_norm / (g_norm + wd * p_norm + eps),
                           lr * torch.ones_like(p_norm))
    v_new = mu * v + local_lr * (g + wd * p32)
    return {"ParamOut": [(p32 - v_new).to(p.dtype)], "VelocityOut": [v_new]}


@register("dgc_momentum", grad=None,
          attrs={"mu": 0.9, "ratio": 0.001, "rampup_begin_step": 0.0,
                 "use_nesterov": False})
def _dgc_momentum(ctx, ins, attrs):
    """Deep Gradient Compression's update: momentum correction (u),
    local residual accumulation (v), and the top `ratio` of |v| applied
    to the parameter while the rest stays local; plain momentum before
    `rampup_begin_step`."""
    p, g = _pg("dgc_momentum", ins)
    u, v = x(ins, "U"), x(ins, "V")
    step = x(ins, "CurrentStep").reshape(())
    lr = _lr(ins)
    g = g.float()
    u_new = attrs["mu"] * u + g
    v_acc = v + u_new
    flat = torch.abs(v_acc.reshape(-1))
    q = min(max(1.0 - attrs["ratio"], 0.0), 1.0)
    thr = torch.quantile(flat, q) if flat.numel() > 1 \
        else flat.new_zeros(())
    mask = (torch.abs(v_acc) >= thr).float()
    in_rampup = step < attrs["rampup_begin_step"]
    p32 = p.float()
    p_new = torch.where(in_rampup, p32 - lr * u_new, p32 - lr * v_acc * mask)
    v_new = torch.where(in_rampup, v, v_acc * (1.0 - mask))
    return {"ParamOut": [p_new.to(p.dtype)], "UOut": [u_new],
            "VOut": [v_new], "CurrentStepOut": [(step + 1.0).reshape(1)]}


@register("localsgd_sync", grad=None, attrs={"k_steps": 1, "begin_step": 1})
def _localsgd_sync(ctx, ins, attrs):
    """LocalSGD's averaging tick: on every k-th step from `begin_step`
    the parameter becomes its data-parallel average."""
    from ...distributed.collective import _op_group
    p = x(ins, "Param")
    step = float(x(ins, "Step").reshape(()))
    k, begin = attrs["k_steps"], attrs["begin_step"]
    if not (step >= begin and step % float(k) == 0.0):
        return {"ParamOut": [p]}
    group, n = _op_group(ctx, {})
    if n == 1:
        return {"ParamOut": [p]}
    import torch.distributed as dist
    avg = p.clone()
    dist.all_reduce(avg, group=group)
    return {"ParamOut": [avg / n]}


# ---------------------------------------------------------------------------
# gradient utilities
# ---------------------------------------------------------------------------

@register("clip_by_norm", attrs={"max_norm": 1.0},
          infer_shape=same_shape_as("X"))
def _clip_by_norm(ctx, ins, attrs):
    v = x(ins)
    n = torch.sqrt(torch.square(v).sum())
    mx = attrs["max_norm"]
    return {"Out": [torch.where(n > mx, v * (mx / torch.clamp(n, min=1e-12)),
                                v)]}


@register("lerp")
def _lerp(ctx, ins, attrs):
    a, b, w = x(ins, "X"), x(ins, "Y"), x(ins, "Weight")
    return {"Out": [a + w * (b - a)]}


@register("check_finite_and_unscale", grad=None)
def _check_finite_and_unscale(ctx, ins, attrs):
    """AMP: Out = X / Scale; FoundInfinite = any non-finite value."""
    scale = x(ins, "Scale").reshape(())
    xs = ins.get("X", [])
    found = torch.zeros((), dtype=torch.bool, device=scale.device)
    outs = []
    for v in xs:
        found = found | ~torch.isfinite(v).all()
        outs.append(v / scale)
    return {"Out": outs, "FoundInfinite": [found.reshape(1)]}


@register("update_loss_scaling", grad=None,
          attrs={"incr_every_n_steps": 1000, "decr_every_n_nan_or_inf": 2,
                 "incr_ratio": 2.0, "decr_ratio": 0.5,
                 "stop_update": False})
def _update_loss_scaling(ctx, ins, attrs):
    """AMP's dynamic loss-scale state machine."""
    found = x(ins, "FoundInfinite").reshape(()).bool()
    scale = x(ins, "PrevLossScaling").reshape(())
    good = x(ins, "InGoodSteps").reshape(()).int()
    bad = x(ins, "InBadSteps").reshape(()).int()
    zero = torch.zeros_like(good)
    bad_new = torch.where(found, bad + 1, zero)
    good_new = torch.where(found, zero, good + 1)
    scale_up = good_new >= attrs["incr_every_n_steps"]
    scale_dn = bad_new >= attrs["decr_every_n_nan_or_inf"]
    new_scale = torch.where(
        scale_dn, torch.clamp(scale * attrs["decr_ratio"], min=1.0),
        torch.where(scale_up, scale * attrs["incr_ratio"], scale))
    good_new = torch.where(scale_up, zero, good_new)
    bad_new = torch.where(scale_dn, zero, bad_new)
    outs = [torch.where(found, torch.zeros_like(v), v)
            for v in ins.get("X", [])]
    return {"Out": outs, "LossScaling": [new_scale.reshape(1)],
            "OutGoodSteps": [good_new.reshape(1)],
            "OutBadSteps": [bad_new.reshape(1)]}


@register("coalesce_tensor", grad=None,
          attrs={"copy_data": True, "use_align": True, "dtype": "float32"})
def _coalesce_tensor(ctx, ins, attrs):
    """N tensors in one flat buffer, and views of it in their shapes."""
    xs = ins.get("Input", [])
    flat = torch.cat([v.reshape(-1) for v in xs])
    outs, off = [], 0
    for v in xs:
        outs.append(flat[off:off + v.numel()].reshape(v.shape))
        off += v.numel()
    return {"Output": outs, "FusedOutput": [flat]}


@register("average_accumulates", grad=None,
          attrs={"average_window": 10000.0, "max_average_window": 10000,
                 "min_average_window": 10000})
def _average_accumulates(ctx, ins, attrs):
    n = x(ins, "in_num_accumulates").reshape(()).long()
    return {"out_sum_1": [x(ins, "in_sum_1") + x(ins, "param")],
            "out_sum_2": [x(ins, "in_sum_2")],
            "out_sum_3": [x(ins, "in_sum_3")],
            "out_num_accumulates": [(n + 1).reshape(1)],
            "out_old_num_accumulates": [x(ins, "in_old_num_accumulates")],
            "out_num_updates": [x(ins, "in_num_updates")]}


# ---------------------------------------------------------------------------
# shape inference: every update op's output mirrors the slot it updates
# (ParamOut ~ Param, Moment1Out ~ Moment1, ...)
# ---------------------------------------------------------------------------

def _optimizer_infer(op):
    for slot, names in op.outputs.items():
        src = op.invar(slot[:-3] if slot.endswith("Out") else slot)
        if src is None or src.shape is None:
            continue
        for n in names:
            op.block.create_var(name=n, shape=tuple(src.shape),
                                dtype=src.dtype)


for _name in ("sgd", "momentum", "adam", "adamw", "adamax", "adagrad",
              "adadelta", "rmsprop", "lamb", "ftrl", "dpsgd",
              "decayed_adagrad", "lars_momentum"):
    lookup(_name).infer_shape = _optimizer_infer

"""Meta-optimizer stack (counterpart of
``paddle_tpu/distributed/fleet/meta_optimizers``): with no
meta-optimizer enabled in the strategy the user's optimizer is returned
as it is. The ``lamb`` and ``lars`` flags replace it, as the
reference's do, by a fluid ``LambOptimizer`` (the strategy's
``lamb_weight_decay``) or ``LarsMomentumOptimizer`` (its
``lars_configs``, the user optimizer's momentum) at its learning rate.
The other flags raise, naming the ROADMAP item that brings what they
wrap: the DGCMomentum, GradientMerge and LocalSGD optimizers (a later
PR of item 11), the static AMP decorator (item 13) and the
RecomputeOptimizer (item 12)."""
from __future__ import annotations

__all__ = ["apply_meta_optimizers"]

# strategy flag -> the item of ROADMAP.md A that ports what it wraps
_QUEUED = {"dgc": "11", "gradient_merge": "11", "localsgd": "11",
           "amp": "13", "recompute": "12"}


def apply_meta_optimizers(optimizer, strategy, role_maker=None):
    from ....fluid import optimizer as fopt
    if strategy is None:
        return optimizer
    on = [k for k in _QUEUED if getattr(strategy, k)]
    if on:
        raise NotImplementedError(
            "fleet meta-optimizers " + ", ".join(
                f"{k} (ROADMAP.md A, item {_QUEUED[k]})" for k in on)
            + " are not ported yet; lamb and lars are, and data "
            "parallelism needs none")
    opt = optimizer
    if strategy.lamb and hasattr(opt, "_learning_rate"):
        opt = fopt.LambOptimizer(
            learning_rate=opt._learning_rate,
            lamb_weight_decay=strategy.lamb_configs["lamb_weight_decay"])
    if strategy.lars and hasattr(opt, "_learning_rate"):
        cfg = strategy.lars_configs
        opt = fopt.LarsMomentumOptimizer(
            learning_rate=opt._learning_rate,
            momentum=getattr(opt, "_momentum", 0.9),
            lars_coeff=cfg.get("lars_coeff", 0.001),
            lars_weight_decay=cfg.get("lars_weight_decay", 0.0005),
            epsilon=cfg.get("epsilon", 0.0),
            parameter_list=getattr(opt, "_parameter_list", None))
    return opt

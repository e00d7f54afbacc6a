"""Meta-optimizer stack (counterpart of
``paddle_tpu/distributed/fleet/meta_optimizers``): with no
meta-optimizer enabled in the strategy the user's optimizer is returned
as it is. As the reference's do, the ``lamb``, ``lars`` and ``dgc``
flags replace it at its learning rate by a fluid ``LambOptimizer`` (the
strategy's ``lamb_weight_decay``), ``LarsMomentumOptimizer`` (its
``lars_configs``, the user optimizer's momentum) or
``DGCMomentumOptimizer`` (its ``dgc_configs``), and ``localsgd`` wraps
the result in a ``LocalSGDOptimizer`` (its ``localsgd_configs``). The
other flags raise, naming the ROADMAP item that brings what they wrap:
GradientMerge and the RecomputeOptimizer (item 12, the sub-block
executor) and the static AMP decorator (item 13)."""
from __future__ import annotations

__all__ = ["apply_meta_optimizers"]

# strategy flag -> the item of ROADMAP.md A that ports what it wraps
_QUEUED = {"gradient_merge": "12", "amp": "13", "recompute": "12"}


def apply_meta_optimizers(optimizer, strategy, role_maker=None):
    from ....fluid import optimizer as fopt
    if strategy is None:
        return optimizer
    on = [k for k in _QUEUED if getattr(strategy, k)]
    if on:
        raise NotImplementedError(
            "fleet meta-optimizers " + ", ".join(
                f"{k} (ROADMAP.md A, item {_QUEUED[k]})" for k in on)
            + " are not ported yet; lamb, lars, dgc and localsgd are, and "
            "data parallelism needs none")
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
    if strategy.dgc and hasattr(opt, "_learning_rate"):
        cfg = strategy.dgc_configs
        opt = fopt.DGCMomentumOptimizer(
            learning_rate=opt._learning_rate,
            momentum=getattr(opt, "_momentum", 0.9),
            rampup_begin_step=cfg.get("rampup_begin_step", 0),
            rampup_step=cfg.get("rampup_step", 1),
            sparsity=tuple(cfg.get("sparsity", (0.999,))),
            parameter_list=getattr(opt, "_parameter_list", None))
    if strategy.localsgd:
        cfg = strategy.localsgd_configs
        opt = fopt.LocalSGDOptimizer(opt, k_steps=cfg.get("k_steps", 1),
                                     begin_step=cfg.get("begin_step", 1))
    return opt

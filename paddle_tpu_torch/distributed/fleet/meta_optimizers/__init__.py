"""Meta-optimizer stack (counterpart of
``paddle_tpu/distributed/fleet/meta_optimizers``): with no meta-optimizer
enabled in the strategy the user's optimizer is returned as it is; each
enabled one raises, naming the ROADMAP item that brings it. The
reference's stack only wraps optimizers the port does not have yet: the
fluid Lamb, LarsMomentum, DGCMomentum, GradientMerge and LocalSGD
optimizers (item 11, with their update ops), the static AMP decorator
(item 13) and the RecomputeOptimizer (item 12)."""
from __future__ import annotations

__all__ = ["apply_meta_optimizers"]

# strategy flag -> the item of ROADMAP.md A that ports what it wraps
_QUEUED = {"lamb": "11", "lars": "11", "dgc": "11", "gradient_merge": "11",
           "localsgd": "11", "amp": "13", "recompute": "12"}


def apply_meta_optimizers(optimizer, strategy, role_maker=None):
    if strategy is None:
        return optimizer
    on = [k for k in _QUEUED if getattr(strategy, k)]
    if on:
        raise NotImplementedError(
            "fleet meta-optimizers " + ", ".join(
                f"{k} (ROADMAP.md A, item {_QUEUED[k]})" for k in on)
            + " are not ported yet; data parallelism needs none")
    return optimizer

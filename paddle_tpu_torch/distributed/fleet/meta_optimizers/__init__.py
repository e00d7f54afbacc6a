"""Meta-optimizer stack (counterpart of
``paddle_tpu/distributed/fleet/meta_optimizers``): with no meta-optimizer
enabled in the strategy the user's optimizer is returned as it is; each
enabled one raises, naming the ROADMAP item that brings it."""
from __future__ import annotations

__all__ = ["apply_meta_optimizers"]

# strategy flag -> the item of ROADMAP.md A that ports it
_QUEUED = {"lamb": "14(c)", "lars": "14(c)", "dgc": "14(c)",
           "gradient_merge": "14(c)", "localsgd": "14(c)", "amp": "14(c)",
           "recompute": "12"}


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

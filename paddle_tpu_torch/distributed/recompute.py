"""Activation recompute (counterpart of
``paddle_tpu/distributed/recompute.py``).

The reference wraps a segment in ``jax.checkpoint`` inside its traced
train step, and passes eager calls through. The port's eager autograd is
its train step, so ``recompute`` is ``torch.utils.checkpoint`` (the
non-reentrant form) whenever autograd records, and a plain call when it
does not: the segment's activations are dropped after the forward and
rebuilt by running it again in the backward.

What the segment reads besides its arguments is put back for the rerun,
so it computes the same values: the dropout seed stream where it stood
(``preserve_rng_state``; the masks are hashes of the seeds, so the same
elements drop), the autocast level, ``composed_ops`` and the open
data-parallel axis (batch reductions over the ranks).
``wrap_layer_recompute`` also rebinds the layer to the tensors it ran on
(``TrainStep`` runs the model through ``torch.func.functional_call``,
whose binding has ended by the time the backward runs).
"""
from __future__ import annotations

import contextlib
import itertools
from typing import Any, Callable

import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..amp.auto_cast import amp_guard, amp_level
from ..nn import functional as F
from . import collective

__all__ = ["recompute", "wrap_layer_recompute"]


def _context_now():
    """A factory of contexts that restore what a segment reads beside
    its arguments as it stands now."""
    seeds, level, composed = F.seed_state(), amp_level(), F._composed
    axes = list(collective._axis_stack)

    @contextlib.contextmanager
    def restored():
        prev = collective._axis_stack[:]
        collective._axis_stack[:] = axes
        try:
            with amp_guard(level > 0, level="O2" if level == 2 else "O1"), \
                    F.seed_scope(*seeds), F.composed_ops(composed):
                yield
        finally:
            collective._axis_stack[:] = prev
    return restored


def recompute(function: Callable, *args, preserve_rng_state: bool = True,
              **kwargs) -> Any:
    """``function(*args, **kwargs)`` with its activations rebuilt in the
    backward. Outside autograd it is a plain call."""
    if not torch.is_grad_enabled():
        return function(*args, **kwargs)
    restored = _context_now() if preserve_rng_state else None
    calls = itertools.count()

    def run(*a, **kw):
        if next(calls) == 0 or restored is None:
            return function(*a, **kw)      # the forward itself
        with restored():                    # a rerun in the backward
            return function(*a, **kw)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=preserve_rng_state, **kwargs)


def _remat_unit_types():
    from .. import nn
    return (nn.TransformerEncoderLayer, nn.TransformerDecoderLayer)


def wrap_layer_recompute(model) -> int:
    """Wrap every transformer-layer sublayer of `model` so its forward runs
    under `recompute`. Returns the number of layers wrapped. Idempotent."""
    units = _remat_unit_types()
    n = 0
    for sub in model.modules():
        if isinstance(sub, units) and not getattr(sub, "_remat_wrapped",
                                                  False):
            orig = sub.forward

            def wrapped(*a, _sub=sub, _orig=orig, **kw):
                if _sub._remat_inside:
                    return _orig(*a, **kw)
                # the tensors the layer runs on now (a TrainStep's
                # leaves under functional_call), for the rerun
                state = dict(itertools.chain(_sub.named_parameters(),
                                             _sub.named_buffers()))

                def bound(*aa, **kk):
                    _sub._remat_inside = True
                    try:
                        return functional_call(_sub, state, aa, kk)
                    finally:
                        _sub._remat_inside = False
                return recompute(bound, *a, **kw)

            sub.forward = wrapped
            sub._remat_wrapped = True
            sub._remat_inside = False
            n += 1
    return n

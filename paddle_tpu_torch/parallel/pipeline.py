"""GPipe ("F-then-B") pipeline parallelism and the stage loop both
schedules share (counterpart of ``paddle_tpu/parallel/pipeline.py``).

The reference runs GPipe as one differentiable XLA computation: a scan
steps the clock, ``ppermute`` rotates activations around the stage ring,
and ``jax.grad`` through the scan is the reverse schedule. The port runs
one process per rank, so a stage runs its actions itself
(``run_stage``): GPipe is every forward, microbatch 0 to M - 1, then
every backward in reverse (``gpipe_actions``); 1F1B takes its order
from ``pipeline_1f1b.stage_actions``. Activations travel to the next
stage and cotangents to the previous one by point-to-point send / recv
over the pp axis's group (``comm.Comm``), tagged with the microbatch.

A stage keeps the autograd graph of a microbatch from its forward to
its backward (with ``cfg.remat``, only each layer's input), so GPipe
holds all M microbatches at its peak and 1F1B at most S - s on stage s.

A stage may add a term of its own to the loss (the MoE load-balance
aux of its layers, the reference 1F1B engine's per-stage aux): its
cotangent is seeded with the microbatch's loss scale on every stage.
The reference's GPipe scan drops that term, so the train step refuses
MoE (and ring attention) under GPipe, as the reference does.
"""
from __future__ import annotations

from typing import Callable

import torch

__all__ = ["check_microbatches", "gpipe_actions", "run_stage"]


def check_microbatches(n_micro: int, n_stages: int):
    if n_stages > 1 and n_micro < n_stages:
        raise ValueError(
            f"need microbatches >= pipeline stages, got {n_micro} < "
            f"{n_stages} (bubble would dominate; reference asserts the same "
            f"in PipelineOptimizer)")


def gpipe_actions(n_stages: int, n_micro: int) -> list[tuple[str, int]]:
    """F-then-B: every forward in microbatch order, then every backward
    in reverse (the order of the reverse of the reference's scan)."""
    check_microbatches(n_micro, n_stages)
    return [("F", m) for m in range(n_micro)] + \
        [("B", m) for m in reversed(range(n_micro))]


def run_stage(actions, forward: Callable, *, first: bool, last: bool,
              comm, group, prev: int | None, nxt: int | None, act_shape,
              act_dtype, device, loss_scale: float) -> list:
    """Run one stage's `actions` (("F", m) / ("B", m)) and return (the
    detached losses of its microbatches (the last stage's; [] on the
    others), the detached sum of its extra loss terms).

    forward(m, x) -> (out, extra): the stage's output for microbatch m
    from its input x (None on the first stage, which embeds its ids) —
    the activation for the next stage, or on the last stage the
    microbatch's mean loss — and a 0-d term the stage adds to that
    microbatch's loss (None for none).
    A backward on the last stage runs its loss's backward scaled by
    `loss_scale`; one with no forward before it (1F1B's last stage) runs
    the forward first. A stage other than the last receives the
    cotangent of its output from `nxt`; every stage but the first sends
    the gradient of its input to `prev` (world ranks, over `group`)."""
    saved, losses, extras = {}, [], []

    def fwd(m):
        x = None
        if not first:
            x = comm.recv(act_shape, act_dtype, device, prev, group, m,
                          "pp_recv").requires_grad_()
        out, extra = forward(m, x)
        if extra is not None:
            extras.append(extra.detach())
        return x, out, extra

    for kind, m in actions:
        if kind == "F":
            x, out, extra = fwd(m)
            if last:
                losses.append(out.detach())
            else:
                comm.send(out, nxt, group, m, "pp_send")
            saved[m] = (x, out, extra)
            continue
        if m in saved:
            x, out, extra = saved.pop(m)
        else:
            x, out, extra = fwd(m)
            losses.append(out.detach())
        if last:
            total = out if extra is None else out + extra
            (total * loss_scale).backward()
        else:
            dy = comm.recv(act_shape, act_dtype, device, nxt, group, m,
                           "pp_recv")
            if extra is None:
                torch.autograd.backward(out, dy)
            else:
                torch.autograd.backward(
                    [out, extra], [dy, torch.full_like(extra, loss_scale)])
        if not first:
            comm.send(x.grad, prev, group, m, "pp_send")
    comm.wait_sends("pp_send")
    extra = torch.stack(extras).sum() * loss_scale if extras else None
    return losses, extra

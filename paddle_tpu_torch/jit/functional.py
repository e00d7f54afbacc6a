"""One train step of a model built on ``paddle_tpu_torch.nn``
(counterpart of ``paddle_tpu/jit/functional.py``).

The reference traces the eager model into one jitted computation and
keeps parameters and optimizer state as device arrays beside the model,
syncing them back with ``write_back()``. The port keeps that shape
without a tracer: ``TrainStep`` owns float32 copies of the trainable
parameters on its device, runs the model on them through
``torch.func.functional_call`` (so the model's own tensors stay
untouched until ``write_back()``), differentiates with
``torch.autograd`` and applies the ported optimizer ops in place.

One call = loss at the parameters BEFORE the update, optional global
norm clip ``min(1, clip / max(||g||, 1e-12))``, then the optimizer's op
per parameter: ``adamw`` or ``adam``, each parameter with its own
(beta1_pow, beta2_pow) pair and the decay coefficient on every
parameter, as the reference applies it; ``momentum`` with one float32
Velocity a parameter; or ``sgd``. The reference hands ``weight_decay``
to every op as ``coeff``, which the momentum and sgd ops do not read, so
``weight_decay`` does nothing under them here either.

Buffers (batch norm's running statistics) go into the model through
the same ``functional_call``; a layer that updates one writes into the
tensor it was given, which is ``self.buffers[name]`` (the reference
gathers the buffers' values after its trace instead).

A parameter shared under two names (a tied embedding) is one leaf: its
gradient sums both uses and it is updated once. The step seed is the
step count unless given; stochastic ops draw their int32 seeds from
``nn.functional.seed_scope(step seed)``. ``donate`` has no meaning here:
updates are in place.

Data parallelism (``mesh=`` a ``distributed.make_mesh({"dp": n})``):
the reference shards the batch over the mesh's "dp" axis inside one
jitted computation, so every reduction over the batch is global. The
port runs one process per rank and computes the same global-batch
function: at construction every rank takes rank 0's parameters and
buffers; each step slices this rank's rows of every batch argument on
the host (a batch the ranks do not divide raises, as the reference's
``device_put`` does), runs the loss with ``collective_axis("dp")`` open
(batch norm and the masked-LM mean reduce over the ranks, and the seed
stream folds the rank in, so no two ranks draw one mask), averages the
gradients over the ranks in flat buckets
(``distributed.parallel.all_reduce_buckets``), then clips by the global
norm and updates identically on every rank; it returns the ranks' mean
loss, the global batch's. ``batch_spec`` is accepted and unused, as in
the reference. ``remat=True`` recomputes every transformer layer in
the backward (``distributed.recompute.wrap_layer_recompute``).
"""
from __future__ import annotations

import contextlib
from typing import Callable

import numpy as np
import torch
from torch.func import functional_call

from ..amp.auto_cast import amp_guard
from ..distributed.collective import all_reduce, collective_axis
from ..distributed.mesh import Mesh
from ..distributed.parallel import all_reduce_buckets, broadcast_tensors
from ..distributed.recompute import wrap_layer_recompute
from ..fluid.ops.optimizer_ops import adam, adamw, lamb, momentum, sgd
from ..models.gpt import disable_tf32, resolve_device
from ..nn import functional as F

__all__ = ["TrainStep", "make_train_step"]


class _LossModule(torch.nn.Module):
    """loss_fn(model, *batch) as a module call, so that functional_call
    swaps the parameters for its whole body (the model's methods beside
    forward, such as loss(), included)."""

    def __init__(self, model, loss_fn):
        super().__init__()
        self.model = model
        self._loss_fn = loss_fn

    def forward(self, *batch):
        return self._loss_fn(self.model, *batch)


class TrainStep:
    """step(*batch, seed=None) -> loss (a 0-d float32 tensor on the
    device). ``device``: the reference has no such argument; the port
    defaults to CUDA and raises without a card unless given "cpu"."""

    def __init__(self, model, loss_fn: Callable, optimizer: str = "adamw",
                 lr=1e-4, weight_decay: float = 0.01, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, grad_clip_norm: float | None = None,
                 donate: bool = True, mesh=None, batch_spec=None,
                 remat: bool = False, amp_level: str | None = None,
                 device=None):
        if optimizer not in ("adam", "adamw", "momentum", "sgd", "lamb"):
            raise ValueError(f"unknown optimizer {optimizer!r}")
        if amp_level not in (None, "O1", "O2"):
            raise ValueError(f"amp_level must be None, 'O1' or 'O2', got "
                             f"{amp_level!r}")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            disable_tf32()
        self.model = model
        self.loss_fn = loss_fn
        self.remat_layers = wrap_layer_recompute(model) if remat else 0
        self._bound = _LossModule(model, loss_fn)
        self._lr = lr
        self._optimizer = optimizer
        # lamb takes its op's weight decay (0.01), as the reference's
        # step does: weight_decay is adamw's coefficient
        self._update = {"adamw": adamw, "lamb": lamb}.get(optimizer, adam)
        self._clip = grad_clip_norm
        self._amp_level = amp_level
        self._hyper = dict(beta1=beta1, beta2=beta2, epsilon=epsilon)
        if optimizer == "adamw":
            self._hyper["coeff"] = weight_decay
        # named_parameters lists a shared parameter once, under its first
        # name; functional_call ties the other names to the same leaf
        self.params = {
            n: p.detach().to(self.device, torch.float32).clone()
            .requires_grad_()
            for n, p in model.named_parameters() if p.requires_grad}
        self.buffers = {n: b.detach().to(self.device).clone()
                        for n, b in model.named_buffers()}
        self.opt_state = {n: self._init_state(p)
                          for n, p in self.params.items()}
        self._step_count = 0
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a distributed.make_mesh() Mesh, "
                            f"got {type(mesh).__name__}")
        self._mesh = mesh
        self._group = mesh.group("dp") if mesh is not None \
            and "dp" in mesh.shape else None
        self.dp = mesh.axis_size("dp") if self._group is not None else 1
        self.dp_rank = mesh.coord("dp") if self._group is not None else 0
        if self.dp > 1:
            with torch.no_grad():
                broadcast_tensors([*self.params.values(),
                                   *self.buffers.values()],
                                  group=self._group)

    def _init_state(self, p):
        if self._optimizer == "momentum":
            return {"Velocity": torch.zeros_like(p, requires_grad=False)}
        if self._optimizer == "sgd":
            return {}
        one = torch.ones((1,), dtype=torch.float32, device=self.device)
        return {"Moment1": torch.zeros_like(p, requires_grad=False),
                "Moment2": torch.zeros_like(p, requires_grad=False),
                "Beta1Pow": one, "Beta2Pow": one.clone()}

    def _batch(self, b):
        """A batch argument on the device; under data parallelism this
        rank's rows of it, cut on the host before the copy."""
        if not isinstance(b, torch.Tensor):
            b = np.asarray(b)
        if self.dp > 1:
            n = b.shape[0] if b.ndim else 0
            if n % self.dp:
                raise ValueError(
                    f"a batch of {n} rows does not split over dp = "
                    f"{self.dp} ranks")
            rows = n // self.dp
            b = b[self.dp_rank * rows:(self.dp_rank + 1) * rows]
        return torch.as_tensor(b).to(self.device)

    def loss(self, *batch, seed: int = 0):
        """loss_fn on the step's parameters under its autocast level and
        the seed stream of `seed`, with autograd recording: this rank's
        term of the global batch's loss under data parallelism."""
        amp_cm = amp_guard(True, level=self._amp_level) \
            if self._amp_level else contextlib.nullcontext()
        dp_cm = collective_axis("dp", self._group) if self.dp > 1 \
            else contextlib.nullcontext()
        state = {f"model.{n}": v for n, v in
                 (*self.params.items(), *self.buffers.items())}
        with amp_cm, dp_cm, F.seed_scope(seed, self.dp_rank):
            out = functional_call(self._bound, state,
                                  tuple(self._batch(b) for b in batch))
        return out.reshape(())

    def __call__(self, *batch, seed: int | None = None):
        self._step_count += 1
        seed = self._step_count if seed is None else seed
        lr = self._lr() if callable(self._lr) else float(self._lr)
        loss = self.loss(*batch, seed=seed)
        leaves = list(self.params.values())
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        with torch.no_grad():
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(leaves, grads)]
            loss = loss.detach()
            if self.dp > 1:
                all_reduce_buckets(grads, group=self._group,
                                   scale=1.0 / self.dp)
                loss = all_reduce(loss.clone(), group=self._group) / self.dp
            self._apply_update(grads, lr)
        return loss

    def _apply_update(self, grads, lr):
        if self._clip:
            sq = [torch.sum(torch.square(g.float())) for g in grads]
            gnorm = torch.sqrt(sum(sq[1:], sq[0]))
            scale = torch.clamp(self._clip / torch.clamp(gnorm, min=1e-12),
                                max=1.0)
            grads = [g * scale for g in grads]
        for (name, p), g in zip(self.params.items(), grads):
            st = self.opt_state[name]
            if self._optimizer == "momentum":
                momentum(p, g, st["Velocity"], lr)
            elif self._optimizer == "sgd":
                sgd(p, g, lr)
            else:
                st["Beta1Pow"], st["Beta2Pow"] = self._update(
                    p, g, st["Moment1"], st["Moment2"], st["Beta1Pow"],
                    st["Beta2Pow"], lr, **self._hyper)

    def write_back(self):
        """Copy the trained values into the model's own parameters and
        buffers (which the steps leave untouched)."""
        with torch.no_grad():
            own = dict(self.model.named_parameters())
            for n, v in self.params.items():
                own[n].copy_(v.to(own[n].device))
            bufs = dict(self.model.named_buffers())
            for n, v in self.buffers.items():
                bufs[n].copy_(v.to(bufs[n].device))


def make_train_step(model, loss_fn, **kwargs) -> TrainStep:
    """loss_fn(model, *batch_tensors) -> scalar tensor."""
    return TrainStep(model, loss_fn, **kwargs)

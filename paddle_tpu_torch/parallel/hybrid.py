"""HybridParallelTrainStep: the GPT train step (counterpart of
``paddle_tpu/parallel/hybrid.py``), on one device so far.

One call = forward + backward of ``gpt_loss`` + global-norm clip +
Paddle's ``adamw`` update on every leaf, as the reference's jitted step:

  * the loss is returned at the parameters BEFORE the update (the
    reference's ``value_and_grad``);
  * clip scale ``min(1, clip / max(||g||, 1e-12))`` over all leaves (not
    ``torch.nn.utils.clip_grad_norm_``, whose ``+1e-6`` differs);
  * weight decay only on leaves whose last name is in ``_DECAY``;
  * one (beta1_pow, beta2_pow) pair shared by every leaf;
  * ``lr`` a float or a callable returning one per step;
  * residual dropout at ``cfg.dropout`` from step k's seed
    ``op_seed(seed, k)`` (the reference folds k into ``PRNGKey(seed)``;
    its masks come from ``jax.random``, the port's from its counter
    hash, ``models.gpt``).

Parameters stay float32 leaves in the reference's layout, block leaves
stacked ``[L, ...]`` (``models.gpt`` unbinds them per step); the AdamW
moments are float32 beside them and everything is updated in place.
The dp/pp/tp/sp/ep mesh axes of the hybrid step come with item 14(b)
(ROADMAP.md A) and raise NotImplementedError when any is above 1;
data parallelism over ``torch.distributed`` is ``jit.TrainStep(mesh=)``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..fluid.ops.optimizer_ops import adamw
from ..models import gpt as G
from ..nn import functional as F

__all__ = ["HybridParallelTrainStep"]

_DECAY = {"wte", "wpe", "wq", "wk", "wv", "wo", "w_up", "w_down",
          "we_up", "we_down"}


class HybridParallelTrainStep:
    """step(ids[B, T]) -> loss (a 0-d float32 tensor on the device).

    ``params``: an optional JAX-layout numpy tree to start from (default
    ``init_gpt_params(cfg, seed)``, as the reference), so that a caller
    holding one tree can hand it to several steps without a second init.
    ``device``: the reference has no such argument; the port defaults to
    CUDA and raises without a card unless given "cpu". ``n_microbatches``
    and ``sharding`` (ZeRO-1 over dp) keep the reference's signature and
    change nothing on one device."""

    def __init__(self, cfg: G.GPTConfig, mesh=None, dp: int = 1,
                 pp: int = 1, tp: int = 1, sp: int = 1, ep: int = 1,
                 n_microbatches: int | None = None, lr=1e-4,
                 weight_decay: float = 0.01, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 grad_clip_norm: float | None = 1.0, seed: int = 0,
                 sharding: bool = False, pipeline_schedule: str = "1F1B",
                 device=None, params: dict | None = None):
        axes = dict(dp=dp, pp=pp, tp=tp, sp=sp, ep=ep)
        if mesh is not None or any(n > 1 for n in axes.values()):
            raise NotImplementedError(
                f"a device mesh ({mesh!r}, {axes}) for the hybrid GPT step "
                f"comes with item 14(b) of the port (ROADMAP.md A); it "
                f"trains on one device")
        if pipeline_schedule not in ("1F1B", "F-then-B", "gpipe"):
            raise ValueError(f"unknown pipeline_schedule "
                             f"{pipeline_schedule!r}")
        self.cfg = cfg
        self._seed = seed
        self._step = 0
        self.device = G.resolve_device(device)
        if self.device.type == "cuda":
            G.disable_tf32()
        self._lr = lr
        self._wd = weight_decay
        self._clip = grad_clip_norm
        self._hyper = dict(beta1=beta1, beta2=beta2, epsilon=epsilon)

        tree = params if params is not None else G.init_gpt_params(cfg, seed)

        def leaf(x):
            return torch.tensor(np.asarray(x, np.float32),
                                device=self.device).requires_grad_()

        self.params = {k: leaf(tree[k])
                       for k in ("wte", "wpe", "lnf_s", "lnf_b")}
        self.params["blocks"] = {k: leaf(v)
                                 for k, v in tree["blocks"].items()}
        # (name, leaf) in the reference's flattening order (sorted keys)
        self._leaves = sorted(
            [(f"blocks.{k}", v) for k, v in self.params["blocks"].items()]
            + [(k, v) for k, v in self.params.items() if k != "blocks"])
        self.opt_state = {n: (torch.zeros_like(p, requires_grad=False),
                              torch.zeros_like(p, requires_grad=False))
                          for n, p in self._leaves}
        one = torch.ones((1,), dtype=torch.float32, device=self.device)
        self._pows = (one, one.clone())

    def loss_fn(self, params, ids, key=None):
        return G.gpt_loss(params, ids, self.cfg, key=key)

    def step_key(self, step: int) -> int:
        """The dropout step seed of step `step` (1 for the first call)."""
        return F.op_seed(self._seed, step)

    def __call__(self, ids):
        ids = torch.as_tensor(np.asarray(ids), device=self.device).long()
        lr = self._lr() if callable(self._lr) else float(self._lr)
        self._step += 1
        loss = self.loss_fn(self.params, ids, self.step_key(self._step))
        grads = torch.autograd.grad(loss, [p for _, p in self._leaves])
        with torch.no_grad():
            self._apply_update(grads, lr)
        return loss.detach()

    def _apply_update(self, grads, lr):
        if self._clip:
            sq = [torch.sum(torch.square(g.float())) for g in grads]
            gnorm = torch.sqrt(sum(sq[1:], sq[0]))
            scale = torch.clamp(self._clip / torch.clamp(gnorm, min=1e-12),
                                max=1.0)
            for g in grads:     # fresh tensors from autograd.grad
                g.mul_(scale)
        b1p, b2p = self._pows
        for (name, p), g in zip(self._leaves, grads):
            m1, m2 = self.opt_state[name]
            coeff = self._wd if name.split(".")[-1] in _DECAY else 0.0
            new_pows = adamw(p, g, m1, m2, b1p, b2p, lr, coeff=coeff,
                             **self._hyper)
        self._pows = new_pows

    def unstacked_params(self) -> dict:
        """The parameters as the reference's numpy pytree (block leaves
        [L, ...]), for parity checks and checkpoint export."""
        def a(t):
            return t.detach().cpu().numpy()
        out = {k: a(v) for k, v in self.params.items() if k != "blocks"}
        out["blocks"] = {k: a(v) for k, v in self.params["blocks"].items()}
        return out

"""HybridParallelTrainStep: GPT training over a (pp, dp, sp, ep, tp)
mesh (counterpart of ``paddle_tpu/parallel/hybrid.py``).

One call = forward + backward of the GPT loss + global-norm clip +
Paddle's ``adamw`` update on every leaf, as the reference's step:

  * the loss is returned at the parameters BEFORE the update (the
    reference's ``value_and_grad``), the same on every rank;
  * clip scale ``min(1, clip / max(||g||, 1e-12))`` over the whole
    model, each leaf counted once (not ``clip_grad_norm_``, whose
    ``+1e-6`` differs);
  * weight decay only on leaves whose last name is in ``_DECAY``;
  * one (beta1_pow, beta2_pow) pair shared by every leaf;
  * ``lr`` a float or a callable returning one per step;
  * residual dropout at ``cfg.dropout`` from step k's seed
    ``op_seed(seed, k)``, the (dp, sp) coordinate d = dp_rank * sp +
    sp_rank folded in as the data-parallel ``TrainStep`` folds its rank
    (d = 0 adds nothing); at pp > 1 microbatch m's seeds come from
    ``op_seed(step seed, m + 1)``, so a (step, stage, microbatch, layer)
    has one mask on every tp and ep rank, which hold the same
    activation.

The reference's step is one SPMD program over a device mesh; the port
runs one process per rank of a ``torch.distributed`` world laid out as
``make_hybrid_mesh`` lays it ("pp", "dp", "sp", "ep", "tp"; tp
innermost), each rank holding its pieces of the tree
(``models.gpt.shard_params`` of ``gpt_param_specs``):

  * dp: each rank takes its rows of the global batch; the gradients are
    averaged over dp in flat buckets (``all_reduce_buckets``, the
    data-parallel step's).
  * tp: Megatron-style blocks with explicit collectives
    (``tensor_parallel.py``); bo and b_down, used on tp rank 0 only, have
    their gradients summed over tp.
  * pp: stage s holds layers [s L/pp, (s+1) L/pp); the first stage also
    the embedding (wte, wpe), the last the head (wte, lnf). Microbatches
    run under "1F1B" (``pipeline_1f1b.stage_actions``) or "F-then-B"
    (GPipe, ``pipeline.gpipe_actions``) with activations and cotangents
    sent point to point; the loss is the mean over microbatches. The
    tied wte's two gradients (embedding and head) are summed over the
    (first, last) pair, so both copies take the same update.
  * sp: the sequence is cut over sp (T must divide): a rank takes
    columns [s T/sp, (s+1) T/sp) of its rows, at positions
    ``wpe[s T/sp + t]``, and ``cfg.attn_impl`` becomes "ring" (ring
    attention over the sp group, ``sequence_parallel.py``). Its loss
    pairs its last position with the next shard's first token (every
    rank holds the whole batch, so the labels are local); the last
    global position has no target, and a rank's loss is its terms' sum
    over the global B (T - 1). Gradients are summed over sp.
  * ep (cfg.num_experts > 0): each block's FFN is a routed expert bank
    (``moe.py``) with E/ep experts a rank, each split over tp; tokens
    are replicated over ep and tp, routed alike on each; the experts'
    tp partials are summed over tp, the combine over ep. Routing sees
    the global batch (capacity, slots, aux), as the reference's
    ``moe_ffn`` does. The loss adds ``moe_aux_weight`` times the aux
    summed over the layers. Expert leaves are never reduced over ep;
    an expert block's biases are added after the tp sums, so none of
    its leaves is summed over tp.
  * ZeRO-1 (``sharding=True``, dp > 1): the AdamW moments of each leaf
    are split over dp on the first dimension its spec leaves whole and
    dp divides; a dp rank updates its slice of the parameter, and the
    slices are all-gathered over dp.

Under pp, sp and MoE need "1F1B" (as in the reference: its GPipe scan
has no per-stage function to host the ring and drops the aux); a stage
adds its layers' aux to the loss with the microbatch's cotangent.

Parameters stay float32 leaves in the reference's layout (block leaves
stacked [L/pp, ...] a stage), the moments float32 beside them, all
updated in place. ``unstacked_params()`` gathers the full tree.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from ..distributed.collective import all_gather, broadcast
from ..distributed.mesh import Mesh
from ..distributed.parallel import all_reduce_buckets
from ..fluid.ops.optimizer_ops import adamw
from ..models import gpt as G
from ..nn import functional as F
from .comm import Comm
from .moe import moe_context
from .pipeline import check_microbatches, gpipe_actions, run_stage
from .pipeline_1f1b import simulate_1f1b, stage_actions
from .sequence_parallel import ring_context
from .sharding import resolve_spec
from .tensor_parallel import TP, tp_block_body, tp_embed, tp_head_loss

__all__ = ["HybridParallelTrainStep", "make_hybrid_mesh", "AXES"]

_DECAY = {"wte", "wpe", "wq", "wk", "wv", "wo", "w_up", "w_down",
          "we_up", "we_down"}
AXES = ("pp", "dp", "sp", "ep", "tp")
# dense blocks' leaves used on tp rank 0 only: their gradients sum over
# tp (an expert block adds its biases after the tp sums, on every rank)
_TP_RANK0 = ("blocks.bo", "blocks.b_down")


def make_hybrid_mesh(dp: int = 1, pp: int = 1, tp: int = 1, sp: int = 1,
                     ep: int = 1) -> Mesh:
    """("pp","dp","sp","ep","tp") mesh over the world's ranks, tp
    innermost (its all-reduces are the most frequent), pp outermost (one
    activation a microbatch crosses it). A mesh of one rank holds this
    rank alone; any other size must be the world's."""
    return Mesh(dict(pp=pp, dp=dp, sp=sp, ep=ep, tp=tp))


class HybridParallelTrainStep:
    """step(ids[B, T]) -> loss (a 0-d float32 tensor on the device).

    Every rank calls the step with the same global batch; B must divide
    by dp, and at pp > 1 by n_microbatches * dp.

    ``params``: an optional full reference-layout numpy tree to start
    from (default ``init_gpt_params(cfg, seed)``, as the reference);
    its leaves may be memmaps, of which a rank reads only its pieces.
    ``device``: the reference has no such argument; the port defaults to
    CUDA and raises without a card unless given "cpu". ``mesh``: a
    ``distributed.mesh.Mesh`` with the five axes (default
    ``make_hybrid_mesh(dp, pp, tp, sp, ep)``)."""

    def __init__(self, cfg: G.GPTConfig, mesh: Mesh | None = None,
                 dp: int = 1, pp: int = 1, tp: int = 1, sp: int = 1,
                 ep: int = 1, n_microbatches: int | None = None, lr=1e-4,
                 weight_decay: float = 0.01, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 grad_clip_norm: float | None = 1.0, seed: int = 0,
                 sharding: bool = False, pipeline_schedule: str = "1F1B",
                 device=None, params: dict | None = None):
        if pipeline_schedule not in ("1F1B", "F-then-B", "gpipe"):
            raise ValueError(f"unknown pipeline_schedule "
                             f"{pipeline_schedule!r}")
        self._schedule = "1F1B" if pipeline_schedule == "1F1B" else "gpipe"
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a paddle_tpu_torch.distributed."
                            f"mesh.Mesh, got {type(mesh).__name__}")
        sizes = ({a: mesh.axis_size(a) for a in AXES} if mesh is not None
                 else dict(pp=pp, dp=dp, sp=sp, ep=ep, tp=tp))
        self.pp, self.dp, self.tp = sizes["pp"], sizes["dp"], sizes["tp"]
        self.sp, self.ep = sizes["sp"], sizes["ep"]
        if self.ep > 1 and cfg.num_experts <= 0:
            raise ValueError("ep>1 needs a MoE model (cfg.num_experts>0)")
        if cfg.num_experts > 0:
            if self.pp > 1 and self._schedule != "1F1B":
                raise NotImplementedError(
                    "MoE x pipeline needs schedule_mode='1F1B' (the GPipe "
                    "scan drops the per-layer load-balance aux; the 1F1B "
                    "schedule threads it through each stage's backward)")
            if self.ep > 1 and cfg.num_experts % self.ep:
                raise ValueError(
                    f"num_experts={cfg.num_experts} not divisible by "
                    f"ep={self.ep}")
        if self.sp > 1:
            if self.pp > 1 and self._schedule != "1F1B":
                raise NotImplementedError(
                    "sp x pp needs schedule_mode='1F1B': the ring "
                    "attention rides inside the 1F1B stage functions; the "
                    "GPipe scan has no per-stage function to host it")
            # sequence parallel => ring attention over the sp axis
            cfg = dataclasses.replace(cfg, attn_impl="ring")
        if self.pp > 1 and cfg.dropout and self._schedule != "1F1B":
            raise NotImplementedError(
                "pipeline dropout needs schedule_mode='1F1B' (its stage "
                "functions re-derive per-(stage, microbatch) seeds; the "
                "reference's GPipe scan carries no rng)")
        if cfg.num_layers % self.pp:
            raise ValueError(
                f"num_layers={cfg.num_layers} not divisible by pp={self.pp}")
        if cfg.num_heads % self.tp:
            raise ValueError(f"num_heads={cfg.num_heads} not divisible by "
                             f"tp={self.tp} (a rank holds whole heads)")
        self.n_micro = n_microbatches or max(2 * self.pp, 1)
        check_microbatches(self.n_micro, self.pp)
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_hybrid_mesh(**sizes)
        self.device = G.resolve_device(device)
        if self.device.type == "cuda":
            G.disable_tf32()
        self._seed = seed
        self._step = 0
        self._lr = lr
        self._wd = weight_decay
        self._clip = grad_clip_norm
        self._hyper = dict(beta1=beta1, beta2=beta2, epsilon=epsilon)

        m = self.mesh
        self.stage = m.coord("pp")
        self.dp_rank = m.coord("dp")
        self.sp_rank = m.coord("sp")
        self.comm = Comm()
        self._tp = TP(m.group("tp"), m.coord("tp"), self.tp, self.comm)
        self._pp_group, self._dp_group = m.group("pp"), m.group("dp")
        # (dp, sp): the ranks that share the batch; every rank asks for
        # the joint groups in one order (their creation is collective)
        self._data_group = m.joint_group(("dp", "sp"))
        self._data_rank = m.joint_coord(("dp", "sp"))
        if cfg.num_experts > 0:
            m.joint_group(("ep", "tp"))
        self.first = self.stage == 0
        self.last = self.stage == self.pp - 1
        self._prev = m.rank_at(pp=self.stage - 1) if not self.first else None
        self._next = m.rank_at(pp=self.stage + 1) if not self.last else None
        self._emb_group = self._embedding_groups() if self.pp > 1 else None

        holds = {"blocks"}
        if self.first:
            holds |= {"wte", "wpe"}
        if self.last:
            holds |= {"wte", "lnf_s", "lnf_b"}
        tree = params if params is not None else G.init_gpt_params(cfg, seed)
        coords = {a: m.coord(a) for a in AXES}
        local = G.shard_params(tree, coords, sizes, names=holds)
        del tree

        def leaf(x):
            return torch.from_numpy(x).to(self.device).requires_grad_()

        self.params = {k: leaf(v) for k, v in local.items() if k != "blocks"}
        self.params["blocks"] = {k: leaf(v)
                                 for k, v in local["blocks"].items()}
        # (name, leaf) in the reference's flattening order (sorted keys)
        self._leaves = sorted(
            [(f"blocks.{k}", v) for k, v in self.params["blocks"].items()]
            + [(k, v) for k, v in self.params.items() if k != "blocks"])
        specs = G.gpt_param_specs(moe=cfg.num_experts > 0)
        self._specs = {n: resolve_spec(
            specs["blocks"][n[7:]] if n.startswith("blocks.") else specs[n],
            sizes, tuple(p.shape)) for n, p in self._leaves}
        self.zero_sharding = bool(sharding) and self.dp > 1
        self._zero_dim = {n: self._free_dim(p, self._specs[n])
                          for n, p in self._leaves} \
            if self.zero_sharding else {}
        self.opt_state = {}
        for n, p in self._leaves:
            shape = list(p.shape)
            if self._zero_dim.get(n) is not None:
                shape[self._zero_dim[n]] //= self.dp
            self.opt_state[n] = tuple(
                torch.zeros(shape, dtype=torch.float32, device=self.device)
                for _ in range(2))
        one = torch.ones((1,), dtype=torch.float32, device=self.device)
        self._pows = (one, one.clone())
        self.last_stats: dict = {}

    # -- layout -------------------------------------------------------------
    def _embedding_groups(self):
        """The (first stage, last stage) group of this rank's line: every
        rank makes every pair's group, in one order (new_group is
        collective over the world)."""
        axis = self.mesh.axis_names.index("pp")
        ranks = np.moveaxis(self.mesh.ranks, axis, -1).reshape(-1, self.pp)
        mine = None
        for line in ranks:
            g = dist.new_group([int(line[0]), int(line[-1])])
            if dist.get_rank() in line:
                mine = g
        return mine

    def _free_dim(self, p, spec):
        """ZeRO-1's dimension of a leaf: the first its spec leaves whole
        that dp divides (None: the moments stay whole)."""
        entries = list(spec) + [None] * (p.dim() - len(spec))
        for i, e in enumerate(entries):
            if e is None and p.shape[i] % self.dp == 0:
                return i
        return None

    def moment_bytes(self) -> int:
        """This rank's bytes of AdamW moments."""
        return sum(t.numel() * t.element_size()
                   for pair in self.opt_state.values() for t in pair)

    # -- forward pieces -------------------------------------------------------
    def loss_fn(self, params, ids, key=None):
        return G.gpt_loss(params, ids, self.cfg, key=key)

    def step_key(self, step: int) -> int:
        """The dropout step seed of step `step` (1 for the first call)."""
        return F.op_seed(self._seed, step)

    def _seeds(self, key, micro=None):
        """(embedding seed, [(attn-out seed, ffn seed)] a layer) of the
        whole model for one step (or microbatch `micro` of it), None
        when no dropout runs: the draw order of ``gpt_forward_aux``."""
        L = self.cfg.num_layers
        if not (self.cfg.dropout and key is not None):
            return None, [None] * L
        if micro is not None:
            key = F.op_seed(key, micro + 1)
        with F.seed_scope(key, self._data_rank):
            emb = F.next_seed()
            return emb, [(F.next_seed(), F.next_seed()) for _ in range(L)]

    def _run_layers(self, x, seeds):
        """This stage's layers on x: (x, the sum of their aux terms
        times cfg.moe_aux_weight, None for dense blocks)."""
        body = tp_block_body(self.cfg, self._tp)
        lps = self.cfg.num_layers // self.pp
        mine = seeds[self.stage * lps:(self.stage + 1) * lps]
        aux = None
        for blk, s in zip(G._layers(self.params["blocks"]), mine):
            x, a = body(x, blk, s)
            if a is not None:
                aux = a if aux is None else aux + a
        if aux is not None:
            aux = self.cfg.moe_aux_weight * aux
        return x, aux

    def _embed(self, ids, emb_seed, pos0=0):
        x = tp_embed(self.params, ids, self.cfg, self._tp, pos0)
        if emb_seed is not None:
            x = F.dropout(x, self.cfg.dropout, seed=emb_seed)
        return x

    # -- the step -----------------------------------------------------------
    def _rows(self, ids):
        B = ids.shape[0]
        if self.pp == 1:
            if B % self.dp:
                raise ValueError(f"batch {B} not divisible by dp={self.dp}")
            b = B // self.dp
            return ids[self.dp_rank * b:(self.dp_rank + 1) * b]
        M = self.n_micro
        if B % M:
            raise ValueError(f"batch {B} not divisible by {M} microbatches")
        if (B // M) % self.dp:
            raise ValueError(f"microbatch {B // M} not divisible by "
                             f"dp={self.dp}")
        mb = B // M // self.dp
        r = self.dp_rank
        return ids.reshape(M, B // M, -1)[:, r * mb:(r + 1) * mb]

    def _columns(self, ids):
        """This rank's columns of `ids` [..., T] (all of them at sp = 1):
        (tokens, labels or None, the position of the first, the global
        count of loss terms of its rows)."""
        if self.sp == 1:
            return ids, None, 0, None
        T = ids.shape[-1]
        if T % self.sp:
            raise ValueError(f"sequence length {T} not divisible by "
                             f"sp={self.sp}")
        n, s = T // self.sp, self.sp_rank
        return (ids[..., s * n:(s + 1) * n],
                ids[..., s * n + 1:(s + 1) * n + 1], s * n,
                ids.shape[-2] * (T - 1))

    def _contexts(self):
        stack = contextlib.ExitStack()
        if self.sp > 1:
            stack.enter_context(ring_context(self.mesh, "sp", self.comm))
        if self.cfg.num_experts > 0:
            stack.enter_context(moe_context(self.mesh, "ep", self.comm))
        return stack

    def loss_and_grads(self, ids):
        """The step's loss (as ``__call__`` returns it) and this rank's
        gradients, reduced as the update takes them (a list in
        ``_leaves`` order), without the update; the step count (and so
        the dropout seed) advances."""
        ids = self._rows(np.asarray(ids))
        self._step += 1
        key = self.step_key(self._step)
        self.comm.reset()
        t0 = time.perf_counter()
        with self._contexts():
            if self.pp == 1:
                loss = self._single_stage(ids, key)
            else:
                loss = self._pipeline(ids, key)
        self._schedule_s = time.perf_counter() - t0
        grads = self._reduce_grads()
        for _, p in self._leaves:
            p.grad = None
        loss = self.comm.all_reduce(loss.float().reshape(1),
                                    self._data_group, "loss")[0] / self.dp
        return loss, grads

    def __call__(self, ids):
        lr = self._lr() if callable(self._lr) else float(self._lr)
        t0 = time.perf_counter()
        loss, grads = self.loss_and_grads(ids)
        with torch.no_grad():
            self._apply_update(grads, lr)
        self.last_stats = {"schedule_s": self._schedule_s,
                           "step_s": time.perf_counter() - t0,
                           **{f"{k}_s": v for k, v in
                              self.comm.seconds.items()}}
        return loss

    def _tensor(self, a):
        return None if a is None else \
            torch.as_tensor(np.ascontiguousarray(a), device=self.device).long()

    def _single_stage(self, ids, key):
        """Forward and backward of the whole model on this rank's rows
        (and columns); returns the detached loss share."""
        toks, labels, pos0, count = self._columns(ids)
        ids_t, labels_t = self._tensor(toks), self._tensor(labels)
        emb_seed, seeds = self._seeds(key)
        x, aux = self._run_layers(self._embed(ids_t, emb_seed, pos0), seeds)
        loss = tp_head_loss(self.params, x, ids_t, self.cfg, self._tp,
                            labels_t, count)
        if aux is not None:
            loss = loss + aux
        loss.backward()
        return loss.detach()

    def _pipeline(self, ids_mb, key):
        """This stage's part of the schedule over the M microbatches;
        returns the step's loss share (the microbatch mean, the stages'
        aux terms added), on every stage."""
        cfg, M = self.cfg, self.n_micro
        toks, labels, pos0, count = self._columns(ids_mb)
        mb, T = toks.shape[1], toks.shape[2]
        ids_t, labels_t = self._tensor(toks), self._tensor(labels)
        seeds = [self._seeds(key, m) for m in range(M)]
        act_dtype = getattr(torch, cfg.amp_dtype) if cfg.amp_dtype \
            else torch.float32

        def forward(m, x):
            emb_seed, layer_seeds = seeds[m]
            if self.first:
                x = self._embed(ids_t[m], emb_seed, pos0)
            y, aux = self._run_layers(x, layer_seeds)
            if self.last:
                return tp_head_loss(
                    self.params, y, ids_t[m], cfg, self._tp,
                    None if labels_t is None else labels_t[m], count), aux
            return y, aux

        actions = (stage_actions(simulate_1f1b(self.pp, M), self.stage)
                   if self._schedule == "1F1B"
                   else gpipe_actions(self.pp, M))
        losses, extra = run_stage(
            actions, forward, first=self.first, last=self.last,
            comm=self.comm, group=self._pp_group, prev=self._prev,
            nxt=self._next, act_shape=(mb, T, cfg.hidden_size),
            act_dtype=act_dtype, device=self.device, loss_scale=1.0 / M)
        loss = (torch.stack(losses).float().mean() if self.last else
                torch.zeros((), dtype=torch.float32, device=self.device))
        if extra is not None:
            loss = loss + extra.float()
        return self.comm.all_reduce(loss.reshape(1), self._pp_group,
                                    "loss")[0]

    # -- gradients and the update ----------------------------------------------
    def _reduce_grads(self):
        """The leaves' gradients, reduced where the layout needs it: a
        dense block's bo and b_down summed over tp, wte summed over the
        (first, last) stage pair, everything summed over sp and averaged
        over dp (one pass over the (dp, sp) group); nothing over ep."""
        grads = []
        for n, p in self._leaves:
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            grads.append(g)
            if n in _TP_RANK0 and not self.cfg.num_experts:
                self.comm.all_reduce(g, self._tp.group, "grad")
            if n == "wte" and self._emb_group is not None:
                self.comm.all_reduce(g, self._emb_group, "grad")
        if self.dp * self.sp > 1:
            with self.comm.timed("dp", grads[0]):
                all_reduce_buckets(grads, group=self._data_group,
                                   scale=1.0 / self.dp)
        return grads

    def _global_norm(self, grads):
        """||g|| over the whole model, each leaf once: leaves split over
        tp and / or ep summed over those axes, stages over pp, wte on
        the first stage only."""
        parts = {}
        for (n, _), g in zip(self._leaves, grads):
            if n == "wte" and self.pp > 1 and not self.first:
                continue
            axes = tuple(a for a in ("ep", "tp") if a in self._specs[n])
            sq = torch.sum(torch.square(g.float()))
            parts[axes] = parts[axes] + sq if axes in parts else sq
        total = torch.zeros((1,), dtype=torch.float32, device=self.device)
        for axes in sorted(parts, key=len, reverse=True):
            s = parts[axes].reshape(1)
            if axes:
                self.comm.all_reduce(s, self.mesh.joint_group(axes), "grad")
            total = total + s
        self.comm.all_reduce(total, self._pp_group, "grad")
        return torch.sqrt(total[0])

    def _apply_update(self, grads, lr):
        if self._clip:
            gnorm = self._global_norm(grads)
            scale = torch.clamp(self._clip / torch.clamp(gnorm, min=1e-12),
                                max=1.0)
            for g in grads:
                g.mul_(scale)
        b1p, b2p = self._pows
        new_pows = self._pows
        gathers = []
        for (name, p), g in zip(self._leaves, grads):
            m1, m2 = self.opt_state[name]
            coeff = self._wd if name.split(".")[-1] in _DECAY else 0.0
            dim = self._zero_dim.get(name)
            if dim is not None:
                n = p.shape[dim] // self.dp
                p_s = p.narrow(dim, self.dp_rank * n, n)
                new_pows = adamw(p_s, g.narrow(dim, self.dp_rank * n, n),
                                 m1, m2, b1p, b2p, lr, coeff=coeff,
                                 **self._hyper)
                gathers.append((p, p_s, dim))
            else:
                new_pows = adamw(p, g, m1, m2, b1p, b2p, lr, coeff=coeff,
                                 **self._hyper)
        for p, p_s, dim in gathers:
            with self.comm.timed("zero", p):
                p.copy_(_gather(p_s, self._dp_group, dim))
        self._pows = new_pows

    # -- export ---------------------------------------------------------------
    def unstacked_params(self) -> dict:
        """The full parameters as the reference's numpy pytree (block
        leaves [L, ...]), on every rank: split leaves gathered over tp
        and ep, stages over pp (collective: every rank calls it)."""
        cfg = self.cfg
        shapes = G.param_shapes(cfg)

        def whole(n, t):
            for i, e in enumerate(self._specs[n]):
                if e in ("tp", "ep"):
                    t = _gather(t, self.mesh.group(e), i)
            return t

        def a(t):
            return t.detach().cpu().numpy()

        out = {"blocks": {}}
        for n, p in self._leaves:
            if n.startswith("blocks."):
                t = whole(n, p.detach())
                out["blocks"][n[7:]] = a(
                    _gather(t, self._pp_group, 0) if self.pp > 1 else t)
        holder = {"wte": 0, "wpe": 0, "lnf_s": self.pp - 1,
                  "lnf_b": self.pp - 1}
        for k, stage in holder.items():
            if k in self.params:
                t = whole(k, self.params[k].detach())
            else:
                t = torch.empty(shapes[k], dtype=torch.float32,
                                device=self.device)
            if self.pp > 1:
                t = t.contiguous()
                broadcast(t, stage, group=self._pp_group)
            out[k] = a(t)
        return out


def _gather(t, group, dim: int):
    """The parts of `group`'s ranks concatenated on `dim`, in rank order
    (`group` has more than one rank)."""
    return torch.cat(all_gather([], t, group=group), dim)

"""HybridParallelTrainStep: GPT training over a (dp, pp, tp) mesh
(counterpart of ``paddle_tpu/parallel/hybrid.py``).

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
    ``op_seed(seed, k)``, data-parallel rank d folded in as the data-
    parallel ``TrainStep`` folds it (d = 0 adds nothing); at pp > 1
    microbatch m's seeds come from ``op_seed(step seed, m + 1)``, so a
    (step, stage, microbatch, layer) has one mask on every tp rank.

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
  * ZeRO-1 (``sharding=True``, dp > 1): the AdamW moments of each leaf
    are split over dp on the first dimension its spec leaves whole and
    dp divides; a dp rank updates its slice of the parameter, and the
    slices are all-gathered over dp.

Parameters stay float32 leaves in the reference's layout (block leaves
stacked [L/pp, ...] a stage), the moments float32 beside them, all
updated in place. ``unstacked_params()`` gathers the full tree. The sp
and ep axes (ring attention, experts) come with item 14(c) of the port
and raise.
"""
from __future__ import annotations

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
from .pipeline import check_microbatches, gpipe_actions, run_stage
from .pipeline_1f1b import simulate_1f1b, stage_actions
from .sharding import resolve_spec
from .tensor_parallel import TP, tp_block_body, tp_embed, tp_head_loss

__all__ = ["HybridParallelTrainStep", "make_hybrid_mesh", "AXES"]

_DECAY = {"wte", "wpe", "wq", "wk", "wv", "wo", "w_up", "w_down",
          "we_up", "we_down"}
AXES = ("pp", "dp", "sp", "ep", "tp")
# replicated leaves used on tp rank 0 only: their gradients sum over tp
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
        for axis, what in (("sp", "sequence parallelism (ring attention)"),
                           ("ep", "expert parallelism (MoE blocks)")):
            if sizes[axis] > 1:
                raise NotImplementedError(
                    f"{axis}={sizes[axis]}: {what} comes with item 14(c) "
                    f"of the port (ROADMAP.md A)")
        self.pp, self.dp, self.tp = sizes["pp"], sizes["dp"], sizes["tp"]
        self.sp, self.ep = sizes["sp"], sizes["ep"]
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
        self.comm = Comm()
        self._tp = TP(m.group("tp"), m.coord("tp"), self.tp, self.comm)
        self._pp_group, self._dp_group = m.group("pp"), m.group("dp")
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
        specs = G.gpt_param_specs()
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
        with F.seed_scope(key, self.dp_rank):
            emb = F.next_seed()
            return emb, [(F.next_seed(), F.next_seed()) for _ in range(L)]

    def _run_layers(self, x, seeds):
        body = tp_block_body(self.cfg, self._tp)
        lps = self.cfg.num_layers // self.pp
        mine = seeds[self.stage * lps:(self.stage + 1) * lps]
        for blk, s in zip(G._layers(self.params["blocks"]), mine):
            x = body(x, blk, s)
        return x

    def _embed(self, ids, emb_seed):
        x = tp_embed(self.params, ids, self.cfg, self._tp)
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

    def __call__(self, ids):
        ids = self._rows(np.asarray(ids))
        lr = self._lr() if callable(self._lr) else float(self._lr)
        self._step += 1
        key = self.step_key(self._step)
        self.comm.reset()
        t0 = time.perf_counter()
        if self.pp == 1:
            ids_t = torch.as_tensor(ids, device=self.device).long()
            emb_seed, seeds = self._seeds(key)
            x = self._run_layers(self._embed(ids_t, emb_seed), seeds)
            loss = tp_head_loss(self.params, x, ids_t, self.cfg, self._tp)
            loss.backward()
            loss = loss.detach()
        else:
            loss = self._pipeline(ids, key)
        t_sched = time.perf_counter() - t0
        grads = self._reduce_grads()
        with torch.no_grad():
            self._apply_update(grads, lr)
        for _, p in self._leaves:
            p.grad = None
        loss = self.comm.all_reduce(loss.float().reshape(1), self._dp_group,
                                    "loss")[0] / self.dp
        self.last_stats = {"schedule_s": t_sched,
                           "step_s": time.perf_counter() - t0,
                           **{f"{k}_s": v for k, v in
                              self.comm.seconds.items()}}
        return loss

    def _pipeline(self, ids_mb, key):
        """This stage's part of the schedule over the M microbatches;
        returns the step's loss (the microbatch mean), on every stage."""
        cfg, M = self.cfg, self.n_micro
        mb, T = ids_mb.shape[1], ids_mb.shape[2]
        ids_t = torch.as_tensor(ids_mb, device=self.device).long()
        seeds = [self._seeds(key, m) for m in range(M)]
        act_dtype = getattr(torch, cfg.amp_dtype) if cfg.amp_dtype \
            else torch.float32

        def forward(m, x):
            emb_seed, layer_seeds = seeds[m]
            if self.first:
                x = self._embed(ids_t[m], emb_seed)
            y = self._run_layers(x, layer_seeds)
            if self.last:
                return tp_head_loss(self.params, y, ids_t[m], cfg, self._tp)
            return y

        actions = (stage_actions(simulate_1f1b(self.pp, M), self.stage)
                   if self._schedule == "1F1B"
                   else gpipe_actions(self.pp, M))
        losses = run_stage(
            actions, forward, first=self.first, last=self.last,
            comm=self.comm, group=self._pp_group, prev=self._prev,
            nxt=self._next, act_shape=(mb, T, cfg.hidden_size),
            act_dtype=act_dtype, device=self.device, loss_scale=1.0 / M)
        loss = (torch.stack(losses).float().mean() if self.last else
                torch.zeros((), dtype=torch.float32, device=self.device))
        return self.comm.all_reduce(loss.reshape(1), self._pp_group,
                                    "loss")[0]

    # -- gradients and the update ----------------------------------------------
    def _reduce_grads(self):
        """The leaves' gradients, reduced where the layout needs it: bo
        and b_down summed over tp, wte summed over the (first, last)
        stage pair, everything averaged over dp."""
        grads = []
        for n, p in self._leaves:
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            grads.append(g)
            if n in _TP_RANK0:
                self.comm.all_reduce(g, self._tp.group, "grad")
            if n == "wte" and self._emb_group is not None:
                self.comm.all_reduce(g, self._emb_group, "grad")
        if self.dp > 1:
            with self.comm.timed("dp", grads[0]):
                all_reduce_buckets(grads, group=self._dp_group,
                                   scale=1.0 / self.dp)
        return grads

    def _global_norm(self, grads):
        """||g|| over the whole model, each leaf once: tp-split leaves
        summed over tp, stages over pp, wte on the first stage only."""
        split, repl = [], []
        for (n, _), g in zip(self._leaves, grads):
            if n == "wte" and self.pp > 1 and not self.first:
                continue
            sq = torch.sum(torch.square(g.float()))
            (split if "tp" in self._specs[n] else repl).append(sq)
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        s = sum(split, zero.clone()).reshape(1)
        self.comm.all_reduce(s, self._tp.group, "grad")
        total = (s + sum(repl, zero.clone()))
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
        leaves [L, ...]), on every rank: split leaves gathered over tp,
        stages over pp (collective: every rank calls it)."""
        cfg = self.cfg
        shapes = G.param_shapes(cfg)

        def whole(n, t):
            for i, e in enumerate(self._specs[n]):
                if e == "tp":
                    t = _gather(t, self._tp.group, i)
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

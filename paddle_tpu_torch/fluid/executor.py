"""Executor: runs a Program block op by op on the device (counterpart of
``paddle_tpu/fluid/executor.py``).

The reference traces the block once with jax and jits it. The port runs
the ops in order on the device, as the C++ reference's executor does
(executor.cc:476): each op's registered compute on torch tensors, where
the ops that the reference sends to a Pallas kernel launch the port's
CUDA kernel. What the analysis of a program needs (which names are
read before they are written, which persistables are read or updated,
the pruned op list) is computed once per (program structure, feed
signature) and cached: that is what the ``compiles`` and ``cache_hits``
counters count. Updated persistables go back into the scope; the
optimizer ops update the scope's tensors in place.

Randomness: every run draws a seed, ``(random_seed * 1000003 + run) mod
2**32`` when the program has a ``random_seed``, else a random one; a
stochastic op draws its int32 from (run seed, its ``_rng_id``) with
``nn.functional.op_seed``, so its forward and its grad op see the same
numbers.

Data parallelism: a program marked ``{"mode": "dp"}``
(``CompiledProgram.with_data_parallel``, ``fleet.minimize``) runs on
this rank's rows of every feed whose first axis the "dp" axis divides
(the reference's ``_val_sharding``; other feeds whole), and before the
first update op of each optimizer (``Program._grad_syncs``) the
gradients it reads are summed over the ranks in flat buckets and scaled
by 1 / ranks (the reference's ``GradientScaleStrategy.CoeffNumDevice``);
a SelectedRows gradient is gathered instead, every rank's rows and
values, scaled the same.
The run holds ``collective_axis("dp")`` open, so the ``c_*`` ops and
batch norm reduce over the ranks; stochastic ops fold the rank into
their seeds; the program's loss (``_sharding_info["loss"]``), when
fetched, is the mean over the ranks: the global batch's mean loss. The
first data-parallel run of a program in a scope gives every rank rank
0's persistables. Over one rank the run is the plain one.

Tensor parallelism (``_sharding_info["tp"]`` > 1, the strategy's
``tensor_parallel``): the program runs over a ``{"dp": -1, "tp": tp}``
mesh, batch rows split over dp only. A persistable whose name matches
one of ``tp_rules`` ((regex, spec) pairs, first match wins) is held in
the scope as this rank's tp slice between runs, by the reference's
resolution rules: a spec with more dimensions than the value is dropped
(beta-pow accumulators stay whole; moments take their weight's rule),
and an axis that does not divide its dimension is dropped. A run
gathers the slices over tp, runs the ops on the whole values and hands
the slices back: compute is replicated over tp, only the persistables'
storage is split. The reference reads no other key: a program marked
``pp`` or ``sp`` (the strategy's pipeline / sequence-parallel flags)
trains data-parallel, as there. ``train_from_dataset`` waits for the
dataset readers (slice 6).
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Sequence

import numpy as np
import torch

from ..nn.functional import op_seed
from ..observability import flight as _flight
from ..observability import registry as _obs
from . import core, registry
from .framework import Block, Program, Variable, default_main_program
from .scope import Scope, global_scope, scope_guard

# executor telemetry, under the reference's names: a rising miss rate
# with a flat run rate means feed shapes or program structure churn
_EXEC_RUNS = _obs.counter(
    "paddle_tpu_executor_runs_total", "Executor.run invocations")
_EXEC_CACHE_HITS = _obs.counter(
    "paddle_tpu_executor_cache_hits_total",
    "run() served by an already-analysed program signature")
_EXEC_COMPILES = _obs.counter(
    "paddle_tpu_executor_compiles_total",
    "new program signatures analysed (cache misses)")
_EXEC_RUN_SECONDS = _obs.histogram(
    "paddle_tpu_executor_run_seconds", "wall time of Executor.run")

__all__ = ["Executor", "ExecContext", "global_scope", "scope_guard",
           "run_block"]


class ExecContext:
    """Per-run context handed to op compute fns: the device, the run's
    seed (``rng`` gives an op its int32 from (seed, ``_rng_id``, the
    data-parallel rank)), test/train mode, and the mesh axis of a
    data-parallel run."""

    def __init__(self, seed: int, is_test: bool = False, device=None,
                 rank: int = 0, mesh_axis: str | None = None):
        self.seed = int(seed)
        self.is_test = is_test
        self.device = torch.device(device or "cpu")
        self.rank = rank
        self.mesh_axis = mesh_axis

    def rng(self, attrs: dict) -> int:
        return op_seed(self.seed, attrs.get("_rng_id", 0), self.rank)

    def generator(self, attrs: dict) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(self.rng(attrs) & 0xFFFFFFFF)
        return g


def _env_get(env: dict, name: str):
    try:
        return env[name]
    except KeyError:
        raise RuntimeError(
            f"variable {name!r} is not initialised — feed it, produce it with "
            f"an op, or run the startup program first") from None


def run_block(block: Block, env: dict, ctx: ExecContext, ops=None,
              before=None) -> dict:
    """Run every op of `block` (or the `ops` subset) against `env`
    (name -> tensor), in order, without autograd recording (grad ops
    record what they need themselves). `before(op, env)`, when given,
    runs ahead of each op."""
    with torch.no_grad():
        for i, op in enumerate(block.ops if ops is None else ops):
            if before is not None:
                before(op, env)
            opdef = registry.require(op.type)
            ins = {slot: [_env_get(env, n) for n in names]
                   for slot, names in op.inputs.items()}
            try:
                outs = opdef.compute(ctx, ins, op.attrs)
            except (RuntimeError, ValueError, TypeError, IndexError) as e:
                shapes = {slot: [tuple(getattr(v, "shape", ())) for v in vals]
                          for slot, vals in ins.items()}
                raise type(e)(f"op {i} ({op.type}), input shapes {shapes}: "
                              f"{e}") from e
            for slot, names in op.outputs.items():
                vals = outs.get(slot) or []
                for name, val in zip(names, vals):
                    if val is not None and name != registry.EMPTY_VAR:
                        env[name] = val
    return env


def _analyze_ops(ops):
    """Find names read before written (external inputs) and all writes."""
    written: set[str] = set()
    ext_reads: set[str] = set()
    for op in ops:
        for n in op.input_arg_names:
            if n not in written:
                ext_reads.add(n)
        for n in op.output_arg_names:
            written.add(n)
    return ext_reads, written


def _prune_to_fetch(program: Program, fetch_names):
    """Backward slice: keep only ops whose outputs (transitively) feed a
    fetch target (reference framework/prune.h + Executor use_prune).
    Fetching only `loss` from a program that also contains optimizer ops
    skips the parameter updates, like the reference."""
    needed = set(fetch_names)
    keep: list = []
    for op in reversed(list(program.global_block().ops)):
        if set(op.output_arg_names) & needed:
            keep.append(op)
            needed.update(op.input_arg_names)
    keep.reverse()
    return keep


class Executor:
    """``Executor(place).run(program, feed, fetch_list, ...)`` (reference
    executor.py:474). `place` defaults to the first card and raises on a
    host without one: the CPU runs a program only when given
    ``CPUPlace()``."""

    def __init__(self, place: core.Place | None = None):
        self.place = place or core.default_place()
        self.device = self.place.torch_device()
        self._cache: dict[tuple, Any] = {}
        self._run_counter = 0
        self._dp_synced: set[tuple[int, int]] = set()
        self.compiles = 0
        self.cache_hits = 0

    def stats(self) -> dict:
        """This executor's run count and plan-cache misses and hits."""
        return {"runs": self._run_counter, "compiles": self.compiles,
                "cache_hits": self.cache_hits}

    # -- public API --------------------------------------------------------
    def run(self, program: Program | None = None, feed: dict | None = None,
            fetch_list: Sequence | None = None, scope: Scope | None = None,
            return_numpy: bool = True, use_program_cache: bool = True,
            use_prune: bool = False):
        _EXEC_RUNS.inc()
        t0 = time.perf_counter()
        try:
            return self._run_impl(program, feed, fetch_list, scope,
                                  return_numpy, use_prune)
        finally:
            _EXEC_RUN_SECONDS.observe(time.perf_counter() - t0)

    def _run_impl(self, program, feed, fetch_list, scope, return_numpy,
                  use_prune):
        program = program if program is not None else default_main_program()
        if hasattr(program, "_program"):  # CompiledProgram wrapper
            program = program._program
        dp = _DataParallel.of(program)
        feed = dict(feed or {})
        scope = scope or global_scope()
        fetch_names = [v.name if isinstance(v, Variable) else str(v)
                       for v in (fetch_list or [])]

        run_ops = None
        if use_prune:
            pc = getattr(program, "_prune_cache", None)
            if pc is None:
                pc = program._prune_cache = {}
            key = tuple(fetch_names)
            if key not in pc:
                ops = _prune_to_fetch(program, fetch_names)
                ext_reads, written = _analyze_ops(ops)
                persistable = {v.name for v in program.list_vars()
                               if v.persistable}
                pc[key] = (ops, ext_reads, written, persistable,
                           (program._structure_key(), "prune", key))
            run_ops, ext_reads, written, persistable, skey = pc[key]
        else:
            if program._analysis_cache is None:
                ext_reads, written = _analyze_ops(program.global_block().ops)
                persistable = {v.name for v in program.list_vars()
                               if v.persistable}
                program._analysis_cache = (ext_reads, written, persistable,
                                           program._structure_key())
            ext_reads, written, persistable, skey = program._analysis_cache

        missing = [n for n in ext_reads - set(feed)
                   if n in persistable and not scope.has(n)]
        if missing:
            raise RuntimeError(
                f"persistable vars {sorted(missing)[:8]} not found in scope "
                f"— run the startup program first")

        feed_names = sorted(feed)
        feed_vals = []
        for n in feed_names:
            var = program.global_block()._var_recursive(n)
            dtype = var.dtype if var is not None and var.dtype else None
            val = feed[n]
            if not isinstance(val, torch.Tensor):
                val = np.asarray(val)
            if var is not None and var.shape is not None:
                declared = var.shape
                ok = len(declared) == val.ndim and all(
                    d < 0 or d == s for d, s in zip(declared, val.shape))
                if not ok:
                    raise ValueError(
                        f"feed {n!r} has shape {tuple(val.shape)} but the "
                        f"graph declares {tuple(declared)}")
            if dp is not None:
                val = dp.rows(val)     # on the host, before the copy
            feed_vals.append(self._to_tensor(val, dtype))

        plan = self._plan(program, skey, feed_names, feed_vals, ext_reads,
                          written, persistable, fetch_names, run_ops)
        upd_names, read_names = plan

        self._run_counter += 1
        seed = ((program.random_seed * 1000003 + self._run_counter)
                & 0xFFFFFFFF if program.random_seed
                else int(np.random.randint(0, 2 ** 31)))
        if dp is not None:
            env: dict[str, Any] = dp.read(scope, read_names, self._dp_synced)
        else:
            env = {n: scope.find_var(n) for n in read_names}
        env.update(zip(feed_names, feed_vals))
        ctx = ExecContext(seed, is_test=program._is_test, device=self.device,
                          rank=dp.rank if dp else 0,
                          mesh_axis="dp" if dp else None)
        with dp.axis() if dp else contextlib.nullcontext():
            run_block(program.global_block(), env, ctx, ops=run_ops,
                      before=dp.before_op if dp else None)
        fetches = [_env_get(env, n) for n in fetch_names]
        if dp is not None:
            fetches = dp.global_fetches(fetch_names, fetches)
        updates = [(n, env[n]) for n in upd_names]
        for n, v in updates:
            scope.set(n, dp.store(n, v) if dp is not None else v)
        if core.get_flags("FLAGS_benchmark")["FLAGS_benchmark"] \
                and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if core.get_flags("FLAGS_check_nan_inf")["FLAGS_check_nan_inf"]:
            self._check_finite(list(zip(fetch_names, fetches)) + updates)
        if return_numpy:
            return core.batched_to_numpy(fetches)
        return fetches

    # -- helpers -------------------------------------------------------------
    def _to_tensor(self, x, dtype=None) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            t = x.to(self.device)
        else:
            arr = np.asarray(x)
            if dtype is not None and dtype != "bfloat16" \
                    and arr.dtype != np.dtype(dtype):
                arr = arr.astype(dtype)
            t = torch.as_tensor(arr, device=self.device)
        if dtype is not None and t.dtype != core.torch_dtype(dtype):
            t = t.to(core.torch_dtype(dtype))
        return t

    @staticmethod
    def _check_finite(named):
        """Post-step NaN/Inf sweep over fetches and updated persistables,
        one stacked reduction and one host read (the reference sweeps
        per step too; for op-level isolation run the ops eagerly)."""
        floats = [(n, v) for n, v in named
                  if isinstance(v, torch.Tensor) and v.is_floating_point()]
        if not floats:
            return
        flags = torch.stack([torch.isfinite(v).all() for _, v in floats])
        bad = [n for (n, _), ok in zip(floats, flags.tolist()) if not ok]
        if bad:
            raise RuntimeError(f"NaN/Inf detected in {bad[:8]} after "
                               f"executor step (FLAGS_check_nan_inf)")

    def _plan(self, program, skey, feed_names, feed_vals, ext_reads, written,
              persistable, fetch_names, run_ops):
        """(updated persistables, names read from the scope) of this
        program signature, cached; a miss counts as a compile."""
        sig = (skey, tuple(fetch_names), program._is_test,
               tuple((n, tuple(v.shape), str(v.dtype))
                     for n, v in zip(feed_names, feed_vals)))
        plan = self._cache.get(sig)
        if plan is not None:
            self._cache[sig] = self._cache.pop(sig)  # refresh LRU order
            _EXEC_CACHE_HITS.inc()
            self.cache_hits += 1
            return plan
        _EXEC_COMPILES.inc()
        self.compiles += 1
        _flight.record("executor", "compile",
                       feeds=[[n, list(v.shape)] for n, v
                              in zip(feed_names, feed_vals)],
                       cache_size=len(self._cache))
        feeds = set(feed_names)
        upd_names = sorted(n for n in persistable if n in written)
        read_names = sorted(n for n in ext_reads
                            if n not in feeds and n in persistable)
        plan = (upd_names, read_names)
        cap = core.get_flags("FLAGS_jit_cache_size")["FLAGS_jit_cache_size"]
        while self._cache and len(self._cache) >= cap:
            self._cache.pop(next(iter(self._cache)))  # evict oldest (LRU)
        if cap > 0:
            self._cache[sig] = plan
        return plan

    # -- dataset training ---------------------------------------------------
    def train_from_dataset(self, *args, **kwargs):
        raise NotImplementedError(
            "Executor.train_from_dataset needs the dataset readers, which "
            "come with slice 6 of the port (ROADMAP.md A)")

    def close(self):
        self._cache.clear()


class _DataParallel:
    """One data-parallel run of a program over the "dp" axis: the global
    mesh's, or with a tp degree that of a {"dp": -1, "tp": tp} mesh."""

    @classmethod
    def of(cls, program: Program):
        info = getattr(program, "_sharding_info", None)
        if not info:
            return None
        from ..distributed.collective import axis_group
        from ..distributed.env import get_world_size
        from ..distributed.mesh import default_mesh, get_mesh
        tp = int(info.get("tp") or 1)
        if tp > 1 and get_world_size() > 1:
            mesh = _tp_mesh(tp)
            return cls(program, info, mesh.group("dp"), mesh.axis_size("dp"),
                       mesh.coord("dp"), mesh)
        group = axis_group("dp")
        if group is None:
            return None
        mesh = get_mesh() or default_mesh()
        return cls(program, info, group, mesh.axis_size("dp"),
                   mesh.coord("dp"))

    def __init__(self, program, info, group, n, rank, tp_mesh=None):
        self.program, self.info = program, info
        self.group, self.n, self.rank = group, n, rank
        self.tp_mesh = tp_mesh
        block = program.global_block()
        self._syncs = {id(block.ops[i]): grads
                       for i, grads in program._grad_syncs
                       if i < len(block.ops)}
        self._specs: dict[str, tuple] = {}
        if tp_mesh is not None and info.get("tp_rules"):
            from ..parallel.sharding import ShardingRules, resolve_spec
            rules = ShardingRules(info["tp_rules"])
            for var in program.list_vars():
                shape = tuple(var.shape or ())
                if not var.persistable or not shape or min(shape) < 0:
                    continue
                spec = resolve_spec(rules.spec(var.name), tp_mesh.shape,
                                    shape)
                if "tp" in spec:
                    self._specs[var.name] = spec

    def rows(self, val):
        """This rank's rows of a feed whose first axis the ranks divide;
        any other feed whole."""
        if self.n > 1 and val.ndim >= 1 and val.shape[0] % self.n == 0:
            b = val.shape[0] // self.n
            return val[self.rank * b:(self.rank + 1) * b]
        return val

    def axis(self):
        from ..distributed.collective import collective_axis
        if self.tp_mesh is not None:
            return collective_axis("dp", self.group)
        return collective_axis("dp")

    def before_op(self, op, env):
        grads = self._syncs.get(id(op))
        if grads and self.n > 1:
            from ..distributed.parallel import all_reduce_buckets
            from .selected_rows import SelectedRows
            dense = []
            for g in grads:
                if isinstance(env.get(g), SelectedRows):
                    env[g] = self._gather_rows(env[g])
                elif g in env:
                    dense.append(env[g])
            all_reduce_buckets(dense, group=self.group, scale=1.0 / self.n)

    def _gather_rows(self, sr):
        """A SelectedRows gradient's sync: every rank takes the rows and
        values of all ranks, in rank order (the whole batch's, in its
        order), the values scaled by 1 / ranks as the dense average is:
        the reference's batch-sharded run's gradient, the whole batch's
        rows."""
        from ..distributed.collective import all_gather
        from .selected_rows import SelectedRows
        rows, vals = sr.rows, sr.values
        counts = [int(c) for c in all_gather(
            [], torch.tensor([rows.numel()], device=rows.device),
            group=self.group)]
        pad = max(counts) - rows.numel()
        rows = torch.cat([rows, rows.new_zeros(pad)])
        vals = torch.cat([vals, vals.new_zeros((pad,) + vals.shape[1:])])
        rs = all_gather([], rows, group=self.group)
        vs = all_gather([], vals, group=self.group)
        return SelectedRows(torch.cat([r[:c] for r, c in zip(rs, counts)]),
                            torch.cat([v[:c] for v, c in zip(vs, counts)])
                            / self.n, sr.height)

    def read(self, scope, names, done: set) -> dict:
        """name -> whole value of the persistables `names`: tp slices
        gathered; on the first run of the program in the scope, every
        rank takes world rank 0's values (`done` holds the (scope,
        program) pairs already synced)."""
        env = {n: self._whole(n, scope.find_var(n)) for n in names}
        key = (id(scope), id(self.program))
        if key not in done:
            import torch.distributed as dist
            from ..distributed.parallel import broadcast_tensors
            broadcast_tensors(
                [env[n] for n in names],
                group=self.group if self.tp_mesh is None
                else dist.group.WORLD)
            done.add(key)
        return env

    def store(self, name, val):
        """What the scope keeps of an updated persistable: its tp slice
        where a rule splits it, else the value."""
        spec = self._specs.get(name)
        if spec is None:
            return val
        from ..parallel.sharding import shard_of
        m = self.tp_mesh
        return shard_of(val, spec, {"tp": m.coord("tp")},
                        {"tp": m.axis_size("tp")}).contiguous()

    def _whole(self, name, val):
        spec = self._specs.get(name)
        var = self.program.global_block()._var_recursive(name)
        if spec is None or tuple(val.shape) == tuple(var.shape):
            return val
        from ..distributed.collective import all_gather
        group = self.tp_mesh.group("tp")
        for i, e in enumerate(spec):
            if e == "tp":
                val = torch.cat(all_gather([], val, group=group), i)
        return val

    def global_fetches(self, names, values):
        """The program's loss averaged over the ranks; the rest as this
        rank computed them."""
        loss = self.info.get("loss")
        if loss not in names or self.n == 1:
            return values
        from ..distributed.collective import all_reduce
        values = list(values)
        i = names.index(loss)
        v = values[i].detach().clone()
        all_reduce(v, group=self.group)
        values[i] = v / self.n
        return values


_TP_MESHES: dict = {}


def _tp_mesh(tp: int):
    """The {"dp": world / tp, "tp": tp} mesh of this world (made once:
    its process groups are collective to make)."""
    from ..distributed.env import get_world_size
    from ..distributed.mesh import make_mesh
    key = (get_world_size(), tp)
    if key not in _TP_MESHES:
        _TP_MESHES[key] = make_mesh({"dp": -1, "tp": tp})
    return _TP_MESHES[key]

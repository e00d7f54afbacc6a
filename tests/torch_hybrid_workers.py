"""Worker processes of tests/test_torch_hybrid_parallel.py,
test_torch_ring_attention.py, test_torch_moe.py and
test_torch_sharded_embedding.py.

``run`` is what ``paddle_tpu_torch.distributed.spawn`` starts in each
rank: it joins the process group from the PADDLE_* env, runs the named
cases one after another on the CPU over gloo (one world serves several
cases, so the file starts few processes) and pickles a dict case ->
result to ``<out>/rank<r>.pkl``. Torch and the port only (no jax), so a
child starts in about two seconds.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch


def run(out: str, cases: list):
    import time
    from paddle_tpu_torch.distributed import env
    # one thread a rank: the world's ranks share the host's cores
    torch.set_num_threads(1)
    env.init_parallel_env()
    res = {}
    for name, case, args in cases:
        t0 = time.perf_counter()
        res[name] = CASES[case](*args)
        res[f"{name}.seconds"] = time.perf_counter() - t0
    with open(os.path.join(out, f"rank{env.get_rank()}.pkl"), "wb") as f:
        pickle.dump(res, f)


def _cfg(**kw):
    from paddle_tpu_torch.models.gpt import GPTConfig
    return GPTConfig.tiny(**kw)


def _local(step):
    """This rank's leaves by name (numpy), and their specs."""
    return ({n: p.detach().numpy().copy() for n, p in step._leaves},
            dict(step._specs))


def hybrid(kw, cfg_kw, ids, steps, full=True):
    """`steps` steps of HybridParallelTrainStep(**kw) on the global batch
    `ids` (every rank the same): the losses, this rank's leaves and
    moment shapes, and the gathered tree (`full`)."""
    from paddle_tpu_torch.parallel import HybridParallelTrainStep
    step = HybridParallelTrainStep(_cfg(**cfg_kw), device="cpu", seed=0,
                                   **kw)
    losses = [float(step(ids)) for _ in range(steps)]
    local, specs = _local(step)
    res = {"losses": losses, "local": local, "specs": specs,
           "coords": {a: step.mesh.coord(a) for a in step.mesh.axis_names},
           "moments": {n: tuple(m1.shape)
                       for n, (m1, _) in step.opt_state.items()},
           "moment_bytes": step.moment_bytes(),
           "zero": step.zero_sharding, "n_micro": step.n_micro}
    if full:
        res["params"] = step.unstacked_params()
    return res


def hybrid_grads(kw, cfg_kw, ids, names):
    """One ``loss_and_grads`` of HybridParallelTrainStep(**kw): the loss,
    the global gradient norm the clip takes, this rank's reduced
    gradients of the leaves `names`, its coordinates and their specs."""
    from paddle_tpu_torch.parallel import HybridParallelTrainStep
    step = HybridParallelTrainStep(_cfg(**cfg_kw), device="cpu", seed=0,
                                   **kw)
    loss, grads = step.loss_and_grads(ids)
    return {"loss": float(loss), "norm": float(step._global_norm(grads)),
            "grads": {n: g.numpy().copy() for (n, _), g in
                      zip(step._leaves, grads) if n in names},
            "specs": {n: step._specs[n] for n in names},
            "coords": {a: step.mesh.coord(a) for a in step.mesh.axis_names}}


def fleet_hybrid(strategy_kw, ids, cfg_kw=None):
    """fleet.hybrid_train_step from a strategy: its mesh shape, the
    microbatches, ZeRO, the ring, and one step's loss."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.base.fleet_base import _fleet
    strategy = fleet.DistributedStrategy()
    for k, v in strategy_kw.items():
        setattr(strategy, k, v)
    _fleet.init(is_collective=True, strategy=strategy)
    step = _fleet.hybrid_train_step(_cfg(**(cfg_kw or {})), seed=0,
                                    device="cpu")
    loss = float(step(ids))
    _fleet.init(is_collective=True)
    return {"shape": dict(step.mesh.shape), "n_micro": step.n_micro,
            "zero": step.zero_sharding, "sp": step.sp, "ep": step.ep,
            "attn_impl": step.cfg.attn_impl, "loss": loss}


def qkv(B=2, H=2, S=256, D=16, seed=0):
    """tests/test_ring_attention.py's inputs (numpy)."""
    rng = np.random.RandomState(seed)
    return [(rng.randn(B, H, S, D).astype(np.float32) * .5)
            for _ in range(3)]


def ring(axes, causal, S, device="cpu", dtype="float32"):
    """Ring attention of this rank's sequence shard of ``qkv(S=S)`` (in
    `dtype` on `device`) over the "sp" axis of Mesh(axes): its output,
    its share of sum(o ** 2) and the gradients of its q, k, v shards
    (float32 numpy)."""
    from paddle_tpu_torch.distributed.mesh import Mesh
    from paddle_tpu_torch.parallel.sequence_parallel import ring_attention
    mesh = Mesh(axes)
    n, s = mesh.axis_size("sp"), mesh.coord("sp")
    piece = slice(s * S // n, (s + 1) * S // n)
    q, k, v = (torch.from_numpy(a[:, :, piece].copy()).to(
        device, getattr(torch, dtype)).requires_grad_() for a in qkv(S=S))
    o = ring_attention(q, k, v, mesh, "sp", causal=causal)
    loss = torch.sum(o.float() ** 2)
    loss.backward()
    return {"sp": s, "out": o.detach().float().cpu().numpy(),
            "loss": float(loss), "device": str(o.device),
            "grads": [t.grad.float().cpu().numpy() for t in (q, k, v)]}


def lookup(axes, V, D, rows, seed=0):
    """tests/test_sparse_embedding.py's sharded lookup on Mesh(axes):
    this rank's embeddings, its share of sum(out ** 2) (the same on
    every mp rank) and the gradient of its table rows; and the
    ValueError of a table mp does not divide."""
    from paddle_tpu_torch.distributed.mesh import Mesh
    from paddle_tpu_torch.parallel.embedding import (
        ShardedEmbedding, shard_rows, sharded_embedding_lookup)
    mesh = Mesh(axes)
    rng = np.random.RandomState(seed)
    table = rng.randn(V, D).astype(np.float32)
    ids = rng.randint(0, V, rows)
    t = torch.from_numpy(shard_rows(table, mesh, "mp").copy()) \
        .requires_grad_()
    out = sharded_embedding_lookup(t, ids, mesh, "mp")
    loss = torch.sum(out ** 2)
    loss.backward()
    try:
        shard_rows(np.zeros((V - 1, D), np.float32), mesh, "mp")
        err = None
    except ValueError as e:
        err = str(e)
    emb = ShardedEmbedding(V, D, mesh, seed=3)
    return {"mp": mesh.coord("mp"), "out": out.detach().numpy(),
            "loss": float(loss), "grad": t.grad.numpy(), "error": err,
            "module_table": emb.table.numpy(),
            "module_out": emb(ids).numpy()}


def widedeep(kw, batches):
    """WideDeepTrainStep(WideDeepConfig.tiny(), **kw) over `batches`:
    the losses, this rank's table shapes and the gathered tree."""
    from paddle_tpu_torch.models.wide_deep import (WideDeepConfig,
                                                   WideDeepTrainStep)
    step = WideDeepTrainStep(WideDeepConfig.tiny(), seed=0, device="cpu",
                             **kw)
    losses = [float(step(*b)) for b in batches]
    params = step.params
    return {"losses": losses,
            "local": {k: tuple(step.local_params[k].shape)
                      for k in ("embed", "wide")},
            "moments": tuple(step.local_opt_state["embed"]["m1"].shape),
            "params": {k: (v.numpy().copy() if k != "mlp" else
                           [{n: t.numpy().copy() for n, t in l.items()}
                            for l in v]) for k, v in params.items()}}


def saved_bytes(schedule, cfg_kw, ids, pp, micro):
    """The peak of bytes autograd holds for the backward over one step
    (``saved_tensors_hooks``: a saved tensor counts from its pack until
    its graph lets it go)."""
    from paddle_tpu_torch.parallel import HybridParallelTrainStep
    step = HybridParallelTrainStep(_cfg(**cfg_kw), pp=pp,
                                   n_microbatches=micro, device="cpu",
                                   pipeline_schedule=schedule)
    live = [0, 0]

    class Held:
        def __init__(self, t):
            self.t = t
            self.n = t.numel() * t.element_size()
            live[0] += self.n
            live[1] = max(live[1], live[0])

        def __del__(self):
            live[0] -= self.n

    with torch.autograd.graph.saved_tensors_hooks(Held, lambda h: h.t):
        step(ids)
    return live[1]


def errors(ids):
    """The messages of the reference's call-time validation errors."""
    from paddle_tpu_torch.parallel import HybridParallelTrainStep
    out = {}
    step = HybridParallelTrainStep(_cfg(), dp=2, pp=2, tp=2,
                                   n_microbatches=4, device="cpu")
    for name, bad in (("batch", ids[:6]), ("rows", ids[:4])):
        try:
            step(bad)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def _static_regression(tp_rules, opt, seed=11):
    """The program of the reference's static tp cases (two fc layers
    and a squared error), minimized by `opt`, marked tp = 2."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.fluid import framework, layers, optimizer
    from paddle_tpu_torch.fluid import unique_name
    pt.enable_static()
    try:
        with unique_name.guard():
            main, startup = framework.Program(), framework.Program()
            main.random_seed = startup.random_seed = seed
            with framework.program_guard(main, startup):
                x = layers.data("x", [-1, 16], "float32")
                y = layers.data("y", [-1, 1], "float32")
                h = layers.fc(x, 32, act="relu")
                pred = layers.fc(h, 1)
                d = layers.elementwise_sub(pred, y)
                loss = layers.mean(layers.elementwise_mul(d, d))
                getattr(optimizer, opt[0])(learning_rate=opt[1]) \
                    .minimize(loss)
    finally:
        pt.disable_static()
    main._sharding_info = {"mode": "dp", "tp": 2, "loss": loss.name,
                           "tp_rules": tp_rules}
    return main, startup, loss


def static_tp(start, tp_rules, opt, feeds):
    """The static tp program from the reference's initial scope `start`
    over this world ({"dp": -1, "tp": 2}): losses, the scope's shapes
    after the run (tp slices where a rule splits), and the whole
    parameters (the slices gathered)."""
    from paddle_tpu_torch.fluid import (CPUPlace, Executor, scope_from_numpy,
                                        scope_guard)
    from paddle_tpu_torch.distributed.collective import all_gather
    main, startup, loss = _static_regression(tp_rules, opt)
    scope = scope_from_numpy(start, CPUPlace())
    with scope_guard(scope):
        exe = Executor(CPUPlace())
        losses = [float(np.ravel(exe.run(main, feed=f,
                                         fetch_list=[loss])[0])[0])
                  for f in feeds]
    from paddle_tpu_torch.fluid.executor import _tp_mesh
    group = _tp_mesh(2).group("tp")
    shapes = {n: tuple(scope.find_var(n).shape)
              for n in scope.local_var_names()}
    whole = {}
    for p in main.all_parameters():
        v = scope.find_var(p.name)
        if tuple(v.shape) != tuple(p.shape):
            dim = next(i for i, (a, b) in enumerate(zip(v.shape, p.shape))
                       if a != b)
            v = torch.cat(all_gather([], v, group=group), dim)
        whole[p.name] = v.numpy().copy()
    return {"losses": losses, "shapes": shapes, "params": whole}


CASES = {"hybrid": hybrid, "fleet_hybrid": fleet_hybrid,
         "saved_bytes": saved_bytes, "errors": errors, "static_tp": static_tp,
         "hybrid_grads": hybrid_grads, "ring": ring, "lookup": lookup,
         "widedeep": widedeep}

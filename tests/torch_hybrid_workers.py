"""Worker processes of tests/test_torch_hybrid_parallel.py.

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


def fleet_hybrid(strategy_kw, ids):
    """fleet.hybrid_train_step from a strategy: its mesh shape, the
    microbatches, ZeRO, and one step's loss."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.base.fleet_base import _fleet
    strategy = fleet.DistributedStrategy()
    for k, v in strategy_kw.items():
        setattr(strategy, k, v)
    _fleet.init(is_collective=True, strategy=strategy)
    step = _fleet.hybrid_train_step(_cfg(), seed=0, device="cpu")
    loss = float(step(ids))
    _fleet.init(is_collective=True)
    return {"shape": dict(step.mesh.shape), "n_micro": step.n_micro,
            "zero": step.zero_sharding, "loss": loss}


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
         "saved_bytes": saved_bytes, "errors": errors, "static_tp": static_tp}

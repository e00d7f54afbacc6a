"""Worker processes of the port's data-parallel tests
(tests/test_torch_distributed.py, tests/test_torch_data_parallel.py).

``run`` is what ``paddle_tpu_torch.distributed.spawn`` starts in each
rank: it joins the process group from the PADDLE_* env, runs one named
case on the CPU over gloo and pickles what the case returns to
``<out>/rank<r>.pkl``. This module imports torch and the port only (no
jax), so a child starts in about two seconds.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch


def run(case: str, out: str, *args):
    from paddle_tpu_torch.distributed import env
    # one thread a rank: the world's ranks share the host's cores with
    # the other test workers (several threads each oversubscribe them)
    torch.set_num_threads(1)
    env.init_parallel_env()
    result = CASES[case](*args)
    with open(os.path.join(out, f"rank{env.get_rank()}.pkl"), "wb") as f:
        pickle.dump(result, f)


def _np(t):
    return t.detach().cpu().numpy().copy()


def _tensors(state):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in state.items()}


# -- collectives -------------------------------------------------------------

def collectives():
    """Every eager collective on rank-dependent inputs, and the c_* ops
    inside a static program run data-parallel."""
    import torch.distributed as dist
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import env, parallel
    r = env.get_rank()
    base = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * r
    res = {"rank": r, "world": env.get_world_size(),
           "backend": dist.get_backend(),
           "penv": (env.ParallelEnv().rank, env.ParallelEnv().nranks,
                    env.ParallelEnv().local_rank,
                    env.ParallelEnv().trainer_endpoints)}
    for name, op in (("sum", C.ReduceOp.SUM), ("max", C.ReduceOp.MAX),
                     ("min", C.ReduceOp.MIN), ("prod", C.ReduceOp.PROD)):
        t = base.clone() + 1
        res[f"all_reduce_{name}"] = _np(C.all_reduce(t, op))
    parts = []
    C.all_gather(parts, base.clone())
    res["all_gather"] = [_np(p) for p in parts]
    res["broadcast"] = _np(C.broadcast(base.clone(), src=1))
    res["reduce"] = _np(C.reduce(base.clone(), dst=1))
    got = torch.empty(3)
    src = [torch.full((3,), 7.0), torch.full((3,), 8.0)]
    res["scatter"] = _np(C.scatter(got, src if r == 0 else None, src=0))
    C.barrier()
    res["split"] = [_np(p) for p in C.split(base, 3, axis=1)]
    # the bucketed gradient all-reduce, mixed dtypes, a 1 KiB budget
    ts = [torch.full((64,), 1.0 + r), torch.full((200,), 2.0 + r),
          torch.full((8,), 3.0 + r, dtype=torch.float64),
          torch.full((16,), 4.0 + r)]
    res["buckets"] = parallel.all_reduce_buckets(ts, 1024, scale=0.5)
    res["bucketed"] = [_np(t) for t in ts]
    res["c_ops"] = _c_ops_program()
    return res


def _c_ops_program():
    """The c_* ops in a static program run data-parallel: every rank
    feeds the same global (4, 6) x and holds its two rows of it."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.fluid import (CPUPlace, Executor, Scope,
                                        framework, layers, scope_guard)
    from paddle_tpu_torch.fluid.compiler import CompiledProgram
    pt.enable_static()
    try:
        main, startup = framework.Program(), framework.Program()
        with framework.program_guard(main, startup):
            x = layers.data("x", [4, 6], "float32")
            block = main.global_block()
            outs = {}
            for op in ("c_allreduce_sum", "c_allreduce_max",
                       "c_allreduce_min", "c_allgather", "c_broadcast",
                       "c_reducescatter", "c_concat", "c_identity",
                       "c_split", "c_sync_calc_stream",
                       "c_sync_comm_stream"):
                o = block.create_var(name=f"{op}_out", dtype="float32")
                attrs = {"root": 1} if op == "c_broadcast" else \
                    {"nranks": 2} if op == "c_split" else {}
                block.append_op(type=op, inputs={"X": [x]},
                                outputs={"Out": [o]}, attrs=attrs)
                outs[op] = o
            block.append_op(type="barrier", inputs={}, outputs={})
        prog = CompiledProgram(main).with_data_parallel()
        with scope_guard(Scope()):
            exe = Executor(CPUPlace())
            exe.run(startup)
            got = exe.run(prog, feed={"x": C_OPS_X},
                          fetch_list=list(outs.values()))
        return dict(zip(outs, got))
    finally:
        pt.disable_static()


C_OPS_X = np.arange(24, dtype=np.float32).reshape(4, 6) ** 1.5


def world_of_one():
    """Collectives with no process group: identities."""
    from paddle_tpu_torch.distributed import collective as C
    t = torch.ones(3)
    C.all_reduce(t)
    parts = []
    C.all_gather(parts, t)
    return {"t": _np(t), "n_parts": len(parts)}


def fail_on_rank_one():
    from paddle_tpu_torch.distributed import env
    if env.get_rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    import time
    time.sleep(30)


def hang():
    import time
    time.sleep(60)


# -- BERT ---------------------------------------------------------------------

def bert_steps(named, cfg_kw, batch, kw, steps=3, naive=False):
    """`steps` TrainStep calls of BERT tiny at dp = 2 on the global
    `batch`: the losses, the parameters after, and this rank's masked
    count. `naive`: each rank's MLM mean over its own masked positions
    (per-rank ratios averaged), the control of the global count."""
    from paddle_tpu_torch.distributed import make_mesh
    from paddle_tpu_torch.jit import make_train_step
    from paddle_tpu_torch.models import bert as pbert
    if naive:
        pbert.batch_total = lambda t: (t, 1)
    pm = pbert.BertForPretraining(pbert.BertConfig.tiny(**cfg_kw))
    pm.load_state_dict(pbert.params_from_jax(named), strict=True)
    pm.train()

    def loss_fn(m, ids, pos, mlm, nsp):
        logits, nsp_logits = m(ids, masked_positions=pos)
        return m.loss(logits, nsp_logits, mlm, nsp)

    step = make_train_step(pm, loss_fn, device="cpu",
                           mesh=make_mesh({"dp": 2}), **kw)
    losses = [float(step(*batch)) for _ in range(steps)]
    return {"losses": losses, "dp": step.dp, "rank": step.dp_rank,
            "params": {n: _np(v) for n, v in step.params.items()}}


def bad_batch():
    """A global batch of 3 rows over 2 ranks raises."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import make_mesh
    from paddle_tpu_torch.jit import make_train_step
    step = make_train_step(nn.Linear(4, 2), lambda m, x: m(x).sum(),
                           device="cpu", mesh=make_mesh({"dp": 2}))
    try:
        step(np.ones((3, 4), np.float32))
    except ValueError as e:
        return str(e)
    return None


# -- dropout ------------------------------------------------------------------

class DropNet(torch.nn.Module):
    """linear -> dropout(p) (or nothing) -> linear; the kept pattern of
    the dropout's output is recorded."""

    def __init__(self, p):
        super().__init__()
        from paddle_tpu_torch import nn
        self.a, self.b = nn.Linear(32, 64), nn.Linear(64, 1)
        self.drop = nn.Dropout(p) if p is not None else nn.Identity()
        self.kept = []

    def forward(self, x):
        h = self.drop(self.a(x))
        self.kept.append(_np(h != 0))
        return self.b(h)


def dropout_masks(state, p, x):
    from paddle_tpu_torch.distributed import make_mesh
    from paddle_tpu_torch.jit import make_train_step
    net = DropNet(p)
    net.load_state_dict(state, strict=False)
    net.train()
    step = make_train_step(net, lambda m, v: m(v).mean(), device="cpu",
                           optimizer="sgd", lr=0.1,
                           mesh=make_mesh({"dp": 2}))
    losses = [float(step(x)) for _ in range(2)]
    return {"losses": losses, "kept": net.kept,
            "params": {n: _np(v) for n, v in step.params.items()}}


# -- conv -> batch norm -> relu -> pool -> fc ---------------------------------

def conv_bn_net(pkg_nn):
    """The conv-BN net, built from either package's layers."""
    class Net(pkg_nn.Layer):
        def __init__(self):
            super().__init__()
            self.conv = pkg_nn.Conv2D(3, 8, 3, padding=1, bias_attr=False)
            self.bn = pkg_nn.BatchNorm2D(8)
            self.relu = pkg_nn.ReLU()
            self.pool = pkg_nn.AdaptiveAvgPool2D((1, 1))
            self.flatten = pkg_nn.Flatten()
            self.fc = pkg_nn.Linear(8, 5)

        def forward(self, x):
            h = self.relu(self.bn(self.conv(x)))
            return self.fc(self.flatten(self.pool(h)))

    return Net()


def conv_bn_steps(state, batches, dp):
    """3 momentum steps (lr 0.1) at dp ranks: losses, then parameters
    and running statistics."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import make_mesh
    from paddle_tpu_torch.jit import make_train_step
    from paddle_tpu_torch.nn import functional as F
    net = conv_bn_net(nn)
    net.load_state_dict(_tensors(state), strict=True)
    net.train()
    step = make_train_step(
        net, lambda m, img, lab: F.cross_entropy(m(img), lab),
        optimizer="momentum", lr=0.1, device="cpu",
        mesh=make_mesh({"dp": dp}) if dp > 1 else None)
    losses = [float(step(img, lab)) for img, lab in batches]
    step.write_back()
    return {"losses": losses,
            "state": {n: _np(v) for n, v in net.state_dict().items()}}


# -- static programs ---------------------------------------------------------

def build_regression(fluid_pkg):
    """tests/test_data_parallel.py's program with either package's fluid:
    x (-1, 8) -> fc 16 relu -> fc 1, mean squared error, SGD 0.05."""
    fw, layers, opt = fluid_pkg.framework, fluid_pkg.layers, \
        fluid_pkg.optimizer
    main, startup = fw.Program(), fw.Program()
    main.random_seed = startup.random_seed = 7
    with fw.program_guard(main, startup), fluid_pkg.unique_name.guard():
        x = layers.data("x", [-1, 8], "float32")
        y = layers.data("y", [-1, 1], "float32")
        h = layers.fc(x, 16, act="relu")
        pred = layers.fc(h, 1)
        d = layers.elementwise_sub(pred, y)
        loss = layers.mean(layers.elementwise_mul(d, d))
        sgd = opt.SGD(learning_rate=0.05)
    return main, startup, loss, sgd


def regression_feeds(steps=20):
    rng = np.random.RandomState(3)
    w_true = rng.randn(8, 1).astype("float32")
    out = []
    for _ in range(steps):
        xb = rng.randn(64, 8).astype("float32")
        out.append({"x": xb, "y": xb @ w_true})
    return out


def build_sparse_regression(fluid_pkg):
    """A sparse embedding under data parallelism: ids (-1, 4) int64 ->
    embedding [50, 8] (is_sparse: the table's gradient is SelectedRows)
    -> summed over the 4 ids -> fc 1, mean squared error, SGD 0.05."""
    fw, layers, opt = fluid_pkg.framework, fluid_pkg.layers, \
        fluid_pkg.optimizer
    main, startup = fw.Program(), fw.Program()
    main.random_seed = startup.random_seed = 7
    with fw.program_guard(main, startup), fluid_pkg.unique_name.guard():
        ids = layers.data("ids", [-1, 4], "int64")
        y = layers.data("y", [-1, 1], "float32")
        emb = layers.embedding(ids, [50, 8], is_sparse=True)
        pred = layers.fc(layers.reduce_sum(emb, dim=1), 1)
        d = layers.elementwise_sub(pred, y)
        loss = layers.mean(layers.elementwise_mul(d, d))
        sgd = opt.SGD(learning_rate=0.05)
    return main, startup, loss, sgd


def sparse_feeds(steps=20):
    """Ids from a 50-row table, repeated within and across the halves of
    each batch of 16; targets a fixed function of the ids."""
    rng = np.random.RandomState(4)
    w_true = rng.randn(50).astype("float32")
    out = []
    for _ in range(steps):
        ids = rng.randint(0, 30, (16, 4)).astype("int64")
        out.append({"ids": ids, "y": w_true[ids].sum(1, keepdims=True)})
    return out


def static_dp(start, how):
    """The regression program from the reference's initial scope `start`,
    20 steps data-parallel: `how` "compiled" (CompiledProgram
    .with_data_parallel), "fleet" (fleet.init(is_collective=True),
    fleet.distributed_optimizer(SGD).minimize), "pipeline" (fleet's
    minimize under strategy.pipeline: the program is marked "pp", which
    the reference's executor does not read), "localsgd" (SGD wrapped in
    LocalSGDOptimizer(k_steps=3), then with_data_parallel),
    "fleet_localsgd" (fleet's minimize under strategy.localsgd) or
    "sparse" (build_sparse_regression's program through
    with_data_parallel, on sparse_feeds)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.fluid import (CPUPlace, Executor, scope_from_numpy,
                                        scope_guard)
    from paddle_tpu_torch.fluid.compiler import CompiledProgram
    pt.enable_static()
    try:
        build = build_sparse_regression if how == "sparse" \
            else build_regression
        main, startup, loss, sgd = build(fluid)
        with fluid.framework.program_guard(main, startup), \
                fluid.unique_name.guard():
            if how in ("fleet", "pipeline", "fleet_localsgd"):
                fleet.init(is_collective=True)
                strategy = fleet.DistributedStrategy()
                strategy.pipeline = how == "pipeline"
                strategy.localsgd = how == "fleet_localsgd"
                strategy.localsgd_configs = {"k_steps": 3, "begin_step": 1}
                fleet.distributed_optimizer(sgd, strategy).minimize(loss)
                prog = main
            else:
                if how == "localsgd":
                    sgd = fluid.optimizer.LocalSGDOptimizer(sgd, k_steps=3)
                sgd.minimize(loss)
                prog = CompiledProgram(main).with_data_parallel(loss.name)
        info = dict(main._sharding_info)
        scope = scope_from_numpy(start, CPUPlace())
        with scope_guard(scope):
            exe = Executor(CPUPlace())
            feeds = sparse_feeds() if how == "sparse" else regression_feeds()
            losses = [float(exe.run(prog, feed=f, fetch_list=[loss])[0][0])
                      for f in feeds]
        params = {p.name: scope.numpy(p.name) for p in main.all_parameters()}
        return {"losses": losses, "params": params, "info": info,
                "worker_num": fleet.worker_num(),
                "worker_index": fleet.worker_index(),
                "first": fleet.is_first_worker()}
    finally:
        pt.disable_static()


def fleet_model(state, x):
    """fleet.distributed_model: the forward of the wrapped layer, then
    scale_loss + backward + apply_collective_grads on this rank's half
    of `x`: the summed gradients are the global batch's."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import env, fleet
    fleet.init(is_collective=True)
    lin = nn.Linear(8, 4)
    lin.load_state_dict(_tensors(state))
    model = fleet.distributed_model(lin)
    r, n = env.get_rank(), env.get_world_size()
    full = model(torch.from_numpy(x))
    rows = x.shape[0] // n
    mine = torch.from_numpy(x[r * rows:(r + 1) * rows])
    loss = model.scale_loss(model(mine).square().mean())
    loss.backward()
    model.apply_collective_grads()
    return {"out": _np(full),
            "grads": {k: _np(p.grad) for k, p in
                      model.named_parameters()},
            "names": [k for k, _ in model.named_parameters()]}


# -- the max / min all-reduce's gradient ---------------------------------------

def build_minmax_program(pkg, op):
    """loss = mean(c_allreduce_<op>(x * w)) with the backward appended,
    built by `pkg` (a namespace of the package's enable_static /
    disable_static, framework, layers and backward modules)."""
    pkg.enable_static()
    try:
        main, startup = pkg.framework.Program(), pkg.framework.Program()
        with pkg.framework.program_guard(main, startup):
            x = pkg.layers.data("x", [4, 3], "float32")
            w = pkg.layers.create_parameter([3], "float32", name="w")
            h = pkg.layers.elementwise_mul(x, w)
            r = main.global_block().create_var(name="r", dtype="float32",
                                               shape=(4, 3))
            main.global_block().append_op(
                type=f"c_allreduce_{op}", inputs={"X": [h]},
                outputs={"Out": [r]})
            loss = pkg.layers.mean(r)
            pkg.backward.append_backward(loss)
    finally:
        pkg.disable_static()
    return main, startup, loss


def minmax_grads():
    """Each op's program run data-parallel over the ranks: the text of
    the error its gradient raises, or None."""
    from types import SimpleNamespace

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.fluid import (CPUPlace, Executor, Scope, backward,
                                        framework, layers, scope_guard)
    from paddle_tpu_torch.fluid.compiler import CompiledProgram
    pkg = SimpleNamespace(enable_static=pt.enable_static,
                          disable_static=pt.disable_static,
                          framework=framework, layers=layers,
                          backward=backward)
    res = {}
    for op in ("max", "min"):
        main, startup, loss = build_minmax_program(pkg, op)
        prog = CompiledProgram(main).with_data_parallel(loss.name)
        with scope_guard(Scope()):
            exe = Executor(CPUPlace())
            exe.run(startup)
            try:
                exe.run(prog, feed={"x": np.ones((4, 3), np.float32)},
                        fetch_list=["w@GRAD"])
                res[op] = None
            except NotImplementedError as e:
                res[op] = str(e)
    return res


CASES = {f.__name__: f for f in (
    collectives, world_of_one, fail_on_rank_one, hang, bert_steps,
    bad_batch, dropout_masks, conv_bn_steps, static_dp, fleet_model,
    minmax_grads)}

"""The port's hybrid GPT step (dp x pp x tp, both pipeline schedules,
ZeRO-1), its 1F1B schedule, the fleet's hybrid strategy and the static
executor's tensor-parallel rules, each against the JAX package on the
same numpy inputs and weights.

The port runs one gloo process a rank on the CPU
(``distributed.spawn`` of tests/torch_hybrid_workers.py, torch and the
port only); one world serves several cases, so the file starts four
worlds (two of 8 ranks, one of 4, one of 2), each bounded by 60 s. The
reference runs its mesh step in this process on the 8 virtual CPU
devices, with the same ``GPTConfig.tiny()``, numpy init (seed 0) and
ids as tests/test_hybrid_parallel.py and tests/test_pipeline_1f1b.py.

Tolerances: losses within 5e-4 absolute over 3 steps (the reference's
own ``test_hybrid_matches_single_device``); parameters after 3 steps
leaf by leaf within ``PARAM`` (float32 sums in another order and the
tp all-reduces'; AdamW's first steps move a leaf by about lr whatever
its gradient's size, so a near-zero gradient's sign decides a whole
step: the absolute part covers that). The static tp programs: the
reference's static tolerance, rtol 2e-3 and atol 1e-4.
"""
import os
import pickle

import numpy as np
import pytest

import jax

from paddle_tpu.models.gpt import GPTConfig as JConfig
from paddle_tpu.parallel.hybrid import HybridParallelTrainStep as JStep
from paddle_tpu.parallel import pipeline_1f1b as jp1f1b

import test_torch_data_parallel as DP
import torch_dp_workers as WD
import torch_hybrid_workers as W
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.models.gpt import GPTConfig
from paddle_tpu_torch.parallel import HybridParallelTrainStep
from paddle_tpu_torch.parallel.pipeline import gpipe_actions
from paddle_tpu_torch.parallel.pipeline_1f1b import (simulate_1f1b,
                                                     stage_actions)

TIMEOUT = 60
LOSS_ATOL = 5e-4
PARAM = dict(rtol=1e-3, atol=2e-5)
STATIC = dict(rtol=2e-3, atol=1e-4)

DP2PP2TP2 = dict(dp=2, pp=2, tp=2, n_microbatches=4)


def _ids(b=8, t=32, seed=0):
    return np.random.RandomState(seed).randint(0, 512, (b, t)) \
        .astype(np.int32)


def _world(tmp_path, nprocs, cases):
    spawn(W.run, args=(str(tmp_path), cases), nprocs=nprocs,
          timeout=TIMEOUT)
    out = []
    for r in range(nprocs):
        with open(os.path.join(tmp_path, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _reference(steps=3, **kw):
    """The reference mesh step's losses and its parameters after."""
    s = JStep(JConfig.tiny(), seed=0, **kw)
    ids = _ids()
    losses = [float(s(ids)) for _ in range(steps)]
    p = jax.tree_util.tree_map(np.asarray, s.unstacked_params())
    return losses, p


def _check_losses(got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        assert abs(a - b) < LOSS_ATOL, f"step {i}: {a} vs {b}"


def _check_params(got, want):
    for k in ("wte", "wpe", "lnf_s", "lnf_b"):
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **PARAM)
    for k, v in want["blocks"].items():
        np.testing.assert_allclose(got["blocks"][k], v, err_msg=k, **PARAM)


# -- the schedule (pure Python) -----------------------------------------------

def test_schedule_simulator_invariants():
    """tests/test_pipeline_1f1b.py's invariants on the port's simulator,
    its tables equal to the reference's, and the per-stage action order
    read off them: F then B of each microbatch, at most S - s in flight."""
    for S, M in [(2, 4), (4, 8), (3, 9), (4, 4)]:
        sched = simulate_1f1b(S, M)
        ref = jp1f1b.simulate_1f1b(S, M)
        assert sched.n_ticks == ref.n_ticks
        for k in ("f_on", "f_micro", "f_slot", "b_on", "b_micro",
                  "recv_on", "recv_slot", "drecv_on", "drecv_slot"):
            np.testing.assert_array_equal(getattr(sched, k),
                                          getattr(ref, k), err_msg=k)
        f_count = np.zeros((S, M), int)
        b_count = np.zeros((S, M), int)
        for t in range(sched.n_ticks):
            for s in range(S):
                if sched.f_on[t, s]:
                    f_count[s, sched.f_micro[t, s]] += 1
                if sched.b_on[t, s]:
                    b_count[s, sched.b_micro[t, s]] += 1
        assert (f_count[:-1] == 1).all(), (S, M)
        assert (f_count[-1] == 0).all()
        assert (b_count == 1).all()
        assert sched.n_xslots <= S, (S, M, sched.n_xslots)
        assert sched.n_dxslots <= 2
        assert sched.n_ticks <= 2 * M + 4 * S
        for s in range(S):
            acts = stage_actions(sched, s)
            assert sorted(m for k, m in acts if k == "B") == list(range(M))
            live = peak = 0
            for k, m in acts:
                if k == "F":
                    live += 1
                elif s < S - 1:
                    assert ("F", m) in acts[:acts.index(("B", m))]
                    live -= 1
                peak = max(peak, live)
            assert peak <= S - s, (S, M, s, acts)
    assert gpipe_actions(2, 3) == [("F", 0), ("F", 1), ("F", 2), ("B", 2),
                                   ("B", 1), ("B", 0)]


def test_the_reference_validation_errors():
    """The reference step's construction errors, raised before any
    rank is asked for (sp and ep: the reference's own checks)."""
    cfg = GPTConfig.tiny()
    with pytest.raises(ValueError, match="unknown pipeline_schedule"):
        HybridParallelTrainStep(cfg, device="cpu", pipeline_schedule="x")
    with pytest.raises(ValueError, match="not divisible by pp=3"):
        HybridParallelTrainStep(cfg, pp=3, device="cpu")
    with pytest.raises(ValueError, match="microbatches >= pipeline stages"):
        HybridParallelTrainStep(cfg, pp=4, n_microbatches=2, device="cpu")
    with pytest.raises(NotImplementedError, match="1F1B"):
        HybridParallelTrainStep(GPTConfig.tiny(dropout=0.1), pp=2,
                                pipeline_schedule="F-then-B", device="cpu")
    with pytest.raises(ValueError, match="num_heads=4 not divisible"):
        HybridParallelTrainStep(cfg, tp=8, device="cpu")
    with pytest.raises(ValueError, match=r"ep>1 needs a MoE model"):
        HybridParallelTrainStep(cfg, ep=2, device="cpu")
    for kw in (dict(sp=2), dict(num_experts=4)):
        c = GPTConfig.tiny(**{k: v for k, v in kw.items()
                              if k == "num_experts"})
        with pytest.raises(NotImplementedError, match="1F1B"):
            HybridParallelTrainStep(c, pp=2, pipeline_schedule="F-then-B",
                                    device="cpu", sp=kw.get("sp", 1))


# -- the layout (pure) ----------------------------------------------------------

def test_param_specs_and_pieces_match_the_reference_sharding():
    """gpt_param_specs are the reference's PartitionSpecs as tuples, and
    shard_params (the weights-carried-across function) hands each rank
    the piece the reference's mesh puts on the device at its coordinates
    (dp 2 x pp 2 x tp 2, block leaves stacked per stage)."""
    from jax.sharding import NamedSharding
    from paddle_tpu.models.gpt import gpt_param_specs as jspecs
    from paddle_tpu.parallel.hybrid import make_hybrid_mesh as jmesh
    from paddle_tpu.parallel.sharding import _restrict
    from paddle_tpu_torch.models.gpt import (gpt_param_specs,
                                             init_gpt_params, shard_params)
    for stacked in (False, True):
        ref, got = jspecs(pp_stacked=stacked), gpt_param_specs(stacked)
        for k in ("wte", "wpe", "lnf_s", "lnf_b"):
            assert tuple(ref[k]) == got[k], k
        for k, v in ref["blocks"].items():
            assert tuple(v) == got["blocks"][k], k
    cfg = GPTConfig.tiny()
    tree = init_gpt_params(cfg, 0)
    mesh = jmesh(dp=2, pp=2, tp=2)
    sizes = dict(mesh.shape)
    specs = jspecs(pp_stacked=True)
    names = mesh.axis_names
    coords_of = {d.id: dict(zip(names, np.argwhere(mesh.devices == d)[0]))
                 for d in mesh.devices.flat}
    L = cfg.num_layers

    def check(value, spec, piece_of):
        arr = jax.device_put(value, NamedSharding(mesh, _restrict(spec,
                                                                  mesh)))
        for shard in arr.addressable_shards:
            c = {a: int(i) for a, i in coords_of[shard.device.id].items()}
            np.testing.assert_array_equal(piece_of(c), np.asarray(shard.data))

    for k in ("wte", "wpe", "lnf_s"):
        check(tree[k], specs[k],
              lambda c, k=k: shard_params(tree, c, sizes)[k])
    for k in ("wq", "bq", "wo", "w_up", "w_down", "b_down"):
        v = tree["blocks"][k]
        check(v.reshape(2, L // 2, *v.shape[1:]), specs["blocks"][k],
              lambda c, k=k: shard_params(tree, c, sizes)["blocks"][k][None])


def test_tp_rule_resolution_matches_the_reference_executor():
    """The static executor's rule resolution: first match wins, a spec
    with more dims than the value is dropped, an axis that does not
    divide its dimension is dropped (the reference's _param_sharding on
    its {"dp": -1, "tp": 2} mesh)."""
    from paddle_tpu.distributed.mesh import make_mesh as jmake_mesh
    from paddle_tpu.fluid.executor import Executor as JExec
    from paddle_tpu_torch.parallel.sharding import (ShardingRules,
                                                    resolve_spec)
    rules = [(r"fc_0\.w_0", (None, "tp")), (r"fc_0", ("tp",)),
             (r"emb", ("tp", None))]
    info = {"tp": 2, "tp_rules": rules}
    mesh = jmake_mesh({"dp": -1, "tp": 2})
    sizes = dict(mesh.shape)
    cases = [("fc_0.w_0", (16, 32)), ("fc_0.w_0_moment1_0", (16, 32)),
             ("fc_0.w_0_beta1_pow_acc_0", (1,)), ("fc_0.b_0", (32,)),
             ("fc_0.b_0", (3,)), ("emb_table", (7, 4)), ("emb", (8, 4)),
             ("fc_1.w_0", (32, 1))]
    port = ShardingRules(rules)
    for name, shape in cases:
        want = tuple(JExec._param_sharding(name, mesh, info, shape).spec)
        got = resolve_spec(port.spec(name), sizes, shape)
        assert got + (None,) * (len(want) - len(got)) == want, \
            (name, shape, got, want)


# -- 8 ranks: dp2 x pp2 x tp2 -------------------------------------------------

@pytest.fixture(scope="module")
def world_a(tmp_path_factory):
    ids = _ids()
    drop = dict(DP2PP2TP2, pipeline_schedule="1F1B")
    cases = [
        ("1F1B", "hybrid", (dict(DP2PP2TP2, pipeline_schedule="1F1B"), {},
                            ids, 3)),
        ("F-then-B", "hybrid", (dict(DP2PP2TP2,
                                     pipeline_schedule="F-then-B"), {},
                                ids, 3)),
        ("dropout", "hybrid", (drop, dict(dropout=0.1), ids, 3, False)),
        ("dropout_again", "hybrid", (drop, dict(dropout=0.1), ids, 3,
                                     False)),
        ("fleet", "fleet_hybrid", (dict(
            pipeline=True, pipeline_configs={"accumulate_steps": 4},
            tensor_parallel=True,
            tensor_parallel_configs={"tensor_parallel_degree": 2},
            hybrid_configs={"dp_degree": 2, "pp_degree": 2,
                            "mp_degree": 1}), ids)),
        ("errors", "errors", (ids,)),
    ]
    return _world(tmp_path_factory.mktemp("world_a"), 8, cases)


@pytest.mark.parametrize("schedule", ["1F1B", "F-then-B"])
def test_dp2_pp2_tp2_matches_the_reference_mesh_step(world_a, schedule):
    want, wparams = _reference(**DP2PP2TP2, pipeline_schedule=schedule)
    for r, res in enumerate(world_a):
        got = res[schedule]
        _check_losses(got["losses"], want)
        assert got["losses"][-1] < got["losses"][0]
        _check_params(got["params"], wparams)
    # rank 5 = (pp 1, dp 0, tp 1): layers 2-3, the head, wte rows 256-511
    local = world_a[5][schedule]["local"]
    assert world_a[5][schedule]["coords"] == {"pp": 1, "dp": 0, "sp": 0,
                                              "ep": 0, "tp": 1}
    assert set(local) == {f"blocks.{k}" for k in wparams["blocks"]} | {
        "wte", "lnf_s", "lnf_b"}
    np.testing.assert_allclose(local["blocks.w_up"],
                               wparams["blocks"]["w_up"][2:, :, 128:],
                               **PARAM)
    np.testing.assert_allclose(local["wte"], wparams["wte"][256:], **PARAM)
    assert "wpe" in world_a[0][schedule]["local"]
    assert "lnf_s" not in world_a[0][schedule]["local"]


def test_1f1b_dropout_is_seeded_and_equal_across_tp(world_a):
    """Dropout 0.1 under 1F1B: finite losses equal on every rank, the
    same trajectory from the same seed, and every leaf the tp ranks
    replicate equal on both: a mask that differed between them would
    give their replicated gradients different values. (The port's masks
    are its own hash's: the reference's jax.random cannot be replayed.)"""
    base = world_a[0]["dropout"]["losses"]
    assert np.isfinite(base).all()
    assert base != world_a[0]["1F1B"]["losses"]
    for res in world_a:
        assert res["dropout"]["losses"] == base
        assert res["dropout_again"]["losses"] == base
    for r in range(0, 8, 2):
        a, b = world_a[r]["dropout"], world_a[r + 1]["dropout"]
        assert a["coords"]["tp"] == 0 and b["coords"]["tp"] == 1
        for n, spec in a["specs"].items():
            if "tp" not in spec:
                np.testing.assert_array_equal(a["local"][n], b["local"][n],
                                              err_msg=n)


def test_fleet_strategy_consumes_pipeline_and_tp(world_a):
    for res in world_a:
        got = res["fleet"]
        assert got["shape"] == {"pp": 2, "dp": 2, "sp": 1, "ep": 1,
                                "tp": 2}
        assert got["n_micro"] == 4
        assert np.isfinite(got["loss"])


def test_batches_the_mesh_does_not_divide_raise(world_a):
    for res in world_a:
        assert "not divisible by 4 microbatches" in res["errors"]["batch"]
        assert "microbatch 1 not divisible by dp=2" in res["errors"]["rows"]


# -- 8 ranks: ZeRO-1 at dp4 x tp2 ------------------------------------------------

@pytest.fixture(scope="module")
def world_b(tmp_path_factory):
    ids = _ids()
    cases = [
        ("plain", "hybrid", (dict(dp=4, tp=2), {}, ids, 3, False)),
        ("zero", "hybrid", (dict(dp=4, tp=2, sharding=True), {}, ids, 3)),
        ("fleet", "fleet_hybrid", (dict(sharding=True, hybrid_configs={
            "dp_degree": 4, "pp_degree": 1, "mp_degree": 2}), ids)),
    ]
    return _world(tmp_path_factory.mktemp("world_b"), 8, cases)


def test_zero1_sharding_optimizer_state(world_b):
    """ZeRO-1: each dp rank holds 1/dp of the moments of a leaf (wq's
    moment slice is 1/8 of the leaf at dp4 x tp2: layers over dp, columns
    over tp), and the losses and parameters are the reference's."""
    want, wparams = _reference(dp=4, tp=2, sharding=True)
    L, D = 4, 64
    for res in world_b:
        z, p = res["zero"], res["plain"]
        assert z["zero"] and not p["zero"]
        assert z["moments"]["blocks.wq"] == (L // 4, D, D // 2)
        assert np.prod(z["moments"]["blocks.wq"]) == L * D * D // 8
        assert p["moments"]["blocks.wq"] == (L, D, D // 2)
        assert z["moment_bytes"] < p["moment_bytes"] / 3
        _check_losses(z["losses"], want)
        _check_losses(p["losses"], want)
        _check_params(z["params"], wparams)


def test_fleet_strategy_consumes_zero_sharding(world_b):
    for res in world_b:
        assert res["fleet"]["zero"]
        assert res["fleet"]["shape"]["dp"] == 4
        assert np.isfinite(res["fleet"]["loss"])


# -- 4 ranks: pp4, tp4, memory, static tp -------------------------------------------

def _static_reference(opt, steps):
    """The reference's static tp program unsharded: its initial scope,
    feeds, losses and parameters (tests/test_hybrid_parallel.py's
    build(seed=11) and data)."""
    import paddle_tpu as paddle
    from paddle_tpu.fluid import Executor, framework, layers, optimizer
    from paddle_tpu.fluid import unique_name
    from paddle_tpu.fluid.scope import Scope, scope_guard
    paddle.enable_static()
    try:
        with unique_name.guard():
            main, startup = framework.Program(), framework.Program()
            main.random_seed = startup.random_seed = 11
            with framework.program_guard(main, startup):
                x = layers.data("x", [-1, 16], "float32")
                y = layers.data("y", [-1, 1], "float32")
                h = layers.fc(x, 32, act="relu")
                pred = layers.fc(h, 1)
                d = layers.elementwise_sub(pred, y)
                loss = layers.mean(layers.elementwise_mul(d, d))
                getattr(optimizer, opt[0])(learning_rate=opt[1]) \
                    .minimize(loss)
        rng = np.random.RandomState(5)
        w_true = rng.randn(16, 1).astype("float32")
        feeds = []
        for _ in range(steps):
            xb = rng.randn(32, 16).astype("float32")
            feeds.append({"x": xb, "y": xb @ w_true})
        scope = Scope()
        with scope_guard(scope):
            exe = Executor()
            exe.run(startup)
            start = {n: np.asarray(scope.find_var(n)).copy()
                     for n in scope.local_var_names()}
            losses = [float(np.ravel(exe.run(main, feed=f,
                                             fetch_list=[loss])[0])[0])
                      for f in feeds]
            params = {p.name: np.asarray(scope.find_var(p.name))
                      for p in main.all_parameters()}
    finally:
        paddle.disable_static()
    return start, feeds, losses, params


SGD_RULES = [(r"fc_0\.w_0", (None, "tp")), (r"fc_0\.b_0", ("tp",))]
ADAM_RULES = [(r"fc_0\.w_0", (None, "tp")), (r"fc_1\.w_0", (None, "tp"))]


@pytest.fixture(scope="module")
def static_refs():
    return {"sgd": _static_reference(("SGD", 0.05), 10),
            "adam": _static_reference(("Adam", 0.01), 3)}


@pytest.fixture(scope="module")
def world_c(tmp_path_factory, static_refs):
    ids = _ids()
    mem_ids = np.random.RandomState(4).randint(0, 512, (16, 64))
    mem_cfg = dict(num_layers=4, hidden_size=128, remat=False)
    sgd, adam = static_refs["sgd"], static_refs["adam"]
    cases = [
        ("pp4", "hybrid", (dict(pp=4, n_microbatches=8), {}, ids, 3)),
        ("tp4", "hybrid", (dict(tp=4), {}, ids, 3)),
        ("mem_gpipe", "saved_bytes", ("F-then-B", mem_cfg, mem_ids, 4, 8)),
        ("mem_1f1b", "saved_bytes", ("1F1B", mem_cfg, mem_ids, 4, 8)),
        ("static_sgd", "static_tp", (sgd[0], SGD_RULES, ("SGD", 0.05),
                                     sgd[1])),
        ("static_adam", "static_tp", (adam[0], ADAM_RULES, ("Adam", 0.01),
                                      adam[1])),
    ]
    return _world(tmp_path_factory.mktemp("world_c"), 4, cases)


@pytest.mark.parametrize("case,kw", [
    ("pp4", dict(pp=4, n_microbatches=8)),
    ("tp4", dict(tp=4)),
])
def test_pp4_and_tp4_match_the_reference_mesh_step(world_c, case, kw):
    want, wparams = _reference(**kw)
    for res in world_c:
        _check_losses(res[case]["losses"], want)
        _check_params(res[case]["params"], wparams)
    assert world_c[0]["pp4"]["n_micro"] == 8


def test_1f1b_holds_fewer_saved_bytes_than_gpipe(world_c):
    """The point of 1F1B (tests/test_pipeline_1f1b.py's memory case at
    M = 8, pp = 4): on every stage the peak of bytes autograd keeps for
    the backward is below GPipe's, which keeps all M microbatches."""
    for r, res in enumerate(world_c):
        assert res["mem_1f1b"] < res["mem_gpipe"], (r, res["mem_1f1b"],
                                                    res["mem_gpipe"])
    # the last stage runs F and B of a microbatch back to back
    assert world_c[3]["mem_1f1b"] * 4 < world_c[3]["mem_gpipe"]


def test_static_tensor_parallel_rules(world_c, static_refs):
    """strategy.tensor_parallel on a static program over dp2 x tp2: the
    rules keep fc_0's weight and bias as tp slices in the scope; losses
    and parameters match the reference's unsharded run."""
    _, _, want, wparams = static_refs["sgd"]
    assert want[-1] < want[0] * 0.5
    for res in world_c:
        got = res["static_sgd"]
        np.testing.assert_allclose(got["losses"], want, **STATIC)
        for n, w in wparams.items():
            np.testing.assert_allclose(got["params"][n], w, err_msg=n,
                                       **STATIC)
        assert got["shapes"]["fc_0.w_0"] == (16, 16)
        assert got["shapes"]["fc_0.b_0"] == (16,)
        assert got["shapes"]["fc_1.w_0"] == (32, 1)


def test_static_tp_with_adam_accumulators(world_c, static_refs):
    """Adam's beta-pow accumulators share the weight's name prefix; the
    rule resolver leaves them whole (a spec with more dims than the
    value is dropped), the moments take the weight's slice, and fc_1's
    [32, 1] weight stays whole (tp does not divide 1)."""
    _, _, want, _ = static_refs["adam"]
    for res in world_c:
        got = res["static_adam"]
        assert np.isfinite(got["losses"]).all()
        np.testing.assert_allclose(got["losses"], want, **STATIC)
        shapes = got["shapes"]
        assert shapes["fc_0.w_0"] == (16, 16)
        assert shapes["fc_1.w_0"] == (32, 1)
        moments = [n for n in shapes if n.startswith("fc_0.w_0_moment")]
        pows = [n for n in shapes if n.startswith("fc_0.w_0_beta")]
        assert moments and pows
        assert all(shapes[n] == (16, 16) for n in moments)
        assert all(shapes[n] == (1,) for n in pows)


# -- 2 ranks: C5 -------------------------------------------------------------------

def test_c5_program_marked_pp_trains_data_parallel(tmp_path):
    """C5: a static program minimized by fleet under strategy.pipeline
    carries {"pp": ...}; the reference's executor reads only "tp", so it
    trains data-parallel there. The port raised NotImplementedError; it
    now trains at dp = 2 and matches the reference's losses at the
    static data-parallel tolerance (rtol 2e-3)."""
    start, want, wparams = DP._reference_regression()
    spawn(WD.run, args=("static_dp", str(tmp_path), start, "pipeline"),
          nprocs=2, timeout=TIMEOUT)
    for r in range(2):
        with open(os.path.join(tmp_path, f"rank{r}.pkl"), "rb") as f:
            out = pickle.load(f)
        assert out["info"]["pp"] is not None
        np.testing.assert_allclose(out["losses"], want, rtol=2e-3,
                                   atol=1e-4)
        for n, w in wparams.items():
            np.testing.assert_allclose(out["params"][n], w, rtol=2e-3,
                                       atol=1e-4, err_msg=n)

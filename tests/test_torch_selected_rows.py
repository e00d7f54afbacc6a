"""SelectedRows in the port (paddle_tpu_torch/fluid/selected_rows.py)
against the JAX package's on the CPU: the is_sparse lookup gradient's
rows and values with duplicate ids; sgd, momentum (with and without
Nesterov), adam (the dense fallback and lazy_mode) and adamw after 5
steps of sparse gradients with repeated ids, parameters and moments
within 1e-6, the rows no id touches bit-equal; merge_selected_rows and
get_tensor_from_selected_rows; the sum of two sparse gradients of a
shared table through append_backward, and its SGD steps; the executor
fetching a SelectedRows."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch as pt
from paddle_tpu.fluid import registry as jreg
from paddle_tpu.fluid.selected_rows import SelectedRows as JSR
from paddle_tpu_torch.fluid import registry as treg
from paddle_tpu_torch.fluid.executor import ExecContext
from paddle_tpu_torch.fluid.selected_rows import SelectedRows as TSR

TOL = dict(rtol=1e-6, atol=1e-6)
H, D = 10, 3
IDS = np.array([[1, 4, 4], [7, 1, 4]])          # 4 thrice, 1 twice


def _rnd(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _ref(op, ins, attrs):
    a = dict(attrs)
    jreg.require(op).fill_default_attrs(a)
    return jreg.require(op).compute(None, ins, a)


def _port(op, ins, attrs):
    a = dict(attrs)
    treg.require(op).fill_default_attrs(a)
    return treg.require(op).compute(ExecContext(0, device="cpu"), ins, a)


@pytest.mark.parametrize("op,ids,pad", [
    ("lookup_table_v2_grad", IDS, -1),
    ("lookup_table_v2_grad", IDS, 4),
    ("lookup_table_grad", IDS[..., None], -1)])
def test_sparse_lookup_gradient_matches_the_reference(op, ids, pad):
    og = _rnd(IDS.shape + (D,), 1)
    w = _rnd((H, D), 2)
    attrs = {"is_sparse": True, "padding_idx": pad}
    r = _ref(op, {"Ids": [jnp.asarray(ids)], "W": [jnp.asarray(w)],
                  "Out@GRAD": [jnp.asarray(og)]}, attrs)["W@GRAD"][0]
    g = _port(op, {"Ids": [torch.as_tensor(ids)], "W": [torch.as_tensor(w)],
                   "Out@GRAD": [torch.as_tensor(og)]}, attrs)["W@GRAD"][0]
    assert isinstance(g, TSR) and isinstance(r, JSR)
    assert g.height == r.height == H and g.rows.dtype == torch.int64
    np.testing.assert_array_equal(g.rows.numpy(), np.asarray(r.rows))
    np.testing.assert_array_equal(g.values.numpy(), np.asarray(r.values))
    np.testing.assert_allclose(g.to_dense().numpy(),
                               np.asarray(r.to_dense()), **TOL)
    m, rm = g.merged(), r.merged()
    np.testing.assert_array_equal(m.rows.numpy(), np.asarray(rm.rows))
    np.testing.assert_allclose(m.values.numpy(), np.asarray(rm.values),
                               **TOL)


@pytest.mark.parametrize("op", ["merge_selected_rows",
                                "get_tensor_from_selected_rows"])
def test_the_selected_rows_helpers_match_the_reference(op):
    rows, vals = IDS.reshape(-1), _rnd((IDS.size, D), 3)
    r = _ref(op, {"X": [JSR(jnp.asarray(rows), jnp.asarray(vals), H)]},
             {})["Out"][0]
    g = _port(op, {"X": [TSR(torch.as_tensor(rows), torch.as_tensor(vals),
                             H)]}, {})["Out"][0]
    if op == "merge_selected_rows":
        np.testing.assert_array_equal(g.rows.numpy(), np.asarray(r.rows))
        g, r = g.values, r.values
    np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
    # a dense tensor passes through, as in the reference
    dense = torch.as_tensor(vals)
    assert _port(op, {"X": [dense]}, {})["Out"][0] is dense


def _state(op):
    z = np.zeros((H, D), np.float32)
    st = {"Param": _rnd((H, D), 4), "LearningRate": np.array([0.1],
                                                             np.float32)}
    if op == "momentum":
        st["Velocity"] = z
    if op in ("adam", "adamw"):
        st.update(Moment1=z, Moment2=z,
                  Beta1Pow=np.ones(1, np.float32),
                  Beta2Pow=np.ones(1, np.float32))
    return st


_OUT = {"ParamOut": "Param", "VelocityOut": "Velocity",
        "Moment1Out": "Moment1", "Moment2Out": "Moment2",
        "Beta1PowOut": "Beta1Pow", "Beta2PowOut": "Beta2Pow"}


@pytest.mark.parametrize("op,attrs", [
    ("sgd", {}),
    ("momentum", {"mu": 0.9}),
    ("momentum", {"mu": 0.9, "use_nesterov": True}),
    ("adam", {}),
    ("adam", {"lazy_mode": True}),
    ("adamw", {"coeff": 0.1}),
    ("adamw", {"coeff": 0.1, "lazy_mode": True})])
def test_five_sparse_steps_match_the_reference(op, attrs):
    """5 steps, each a SelectedRows gradient over the same repeated ids
    with new values: every state within 1e-6 of the reference's; the
    rows no id touches keep their bits (their accumulators start at 0)
    except under adamw, whose decay moves every row."""
    jst = {k: jnp.asarray(v) for k, v in _state(op).items()}
    tst = {k: torch.as_tensor(v.copy()) for k, v in _state(op).items()}
    p0 = tst["Param"].clone()
    rows = IDS.reshape(-1)
    for step in range(5):
        vals = _rnd((rows.size, D), 10 + step)
        jo = _ref(op, {**{k: [v] for k, v in jst.items()},
                       "Grad": [JSR(jnp.asarray(rows), jnp.asarray(vals),
                                    H)]}, attrs)
        to = _port(op, {**{k: [v] for k, v in tst.items()},
                        "Grad": [TSR(torch.as_tensor(rows),
                                     torch.as_tensor(vals), H)]}, attrs)
        for slot, src in _OUT.items():
            if slot in jo:
                jst[src], tst[src] = jo[slot][0], to[slot][0]
        for k in jst:
            np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                       err_msg=f"{op} {k} step {step}",
                                       **TOL)
    untouched = np.setdiff1d(np.arange(H), rows)
    moved = tst["Param"].numpy()
    if op == "adamw":
        assert (moved[untouched] != p0.numpy()[untouched]).all()
    else:
        np.testing.assert_array_equal(moved[untouched],
                                      p0.numpy()[untouched])
    assert (moved[np.unique(rows)] != p0.numpy()[np.unique(rows)]).any(1) \
        .all()


def test_the_other_update_ops_raise_on_sparse_rows():
    st = {k: [torch.as_tensor(v)] for k, v in _state("sgd").items()}
    sr = TSR(torch.as_tensor([1, 2]), torch.ones(2, D), H)
    with pytest.raises(NotImplementedError, match="dense gradient"):
        _port("adagrad", {**st, "Grad": [sr],
                          "Moment": [torch.zeros(H, D)]}, {})
    with pytest.raises(NotImplementedError, match="l2_decay"):
        _port("momentum", {**st, "Grad": [sr],
                           "Velocity": [torch.zeros(H, D)]},
              {"regularization_method": "l2_decay",
               "regularization_coeff": 0.1})


def _shared_table(mod, fluid):
    """Two lookups of one sparse table (a word and its context share the
    embedding), an fc and a squared error, SGD 0.5: the table's gradient
    is the sum of two SelectedRows."""
    L = fluid.layers
    mod.enable_static()
    try:
        with fluid.unique_name.guard():
            main, startup = fluid.Program(), fluid.Program()
            main.random_seed = startup.random_seed = 3
            with fluid.program_guard(main, startup):
                a = L.data("a", [-1, 3], "int64")
                b = L.data("b", [-1, 2], "int64")
                y = L.data("y", [-1, 1], "float32")
                attr = fluid.ParamAttr(name="table")
                ea = L.embedding(a, [H, D], is_sparse=True, param_attr=attr)
                eb = L.embedding(b, [H, D], is_sparse=True, param_attr=attr)
                s = L.elementwise_add(L.reduce_sum(ea, dim=[1]),
                                      L.reduce_sum(eb, dim=[1]))
                d = L.elementwise_sub(L.fc(s, 1), y)
                loss = L.mean(L.elementwise_mul(d, d))
                fluid.optimizer.SGD(learning_rate=0.05).minimize(loss)
    finally:
        mod.disable_static()
    return main, startup, loss


def _shared_feeds():
    r = np.random.RandomState(5)
    return [{"a": r.randint(0, H - 2, (4, 3)), "b": r.randint(0, H - 2,
                                                               (4, 2)),
             "y": r.randn(4, 1).astype(np.float32)} for _ in range(4)]


def test_the_sum_of_two_sparse_gradients_of_a_shared_table():
    """The backward sums the two lookups' SelectedRows (rows
    concatenated); 4 SGD steps: losses and the table within 1e-6 of the
    reference's; the last two rows, which no feed looks up, keep their
    bits; the fetched gradient is a SelectedRows equal to the
    reference's, row for row."""
    from paddle_tpu import fluid as jf
    from paddle_tpu.fluid.scope import Scope, scope_guard as jguard
    from paddle_tpu_torch import fluid as tf
    jm, js, jl = _shared_table(paddle_tpu, jf)
    tm, _, tl = _shared_table(pt, tf)
    sums = [op.input("X") for op in tm.global_block().ops
            if op.type == "sum" and op.output("Out") == ["table@GRAD"]]
    assert sums == [["table@GRAD", "table@GRAD@RENAME@1"]]
    feeds = _shared_feeds()
    scope = Scope()
    with jguard(scope):
        exe = jf.Executor()
        exe.run(js)
        start = {n: np.asarray(scope.find_var(n)).copy()
                 for n in scope.local_var_names()}
        jr = [exe.run(jm, feed=f, fetch_list=[jl, "table@GRAD"])
              for f in feeds]
        jtable = np.asarray(scope.find_var("table"))
    tscope = tf.scope_from_numpy(start, tf.CPUPlace())
    with tf.scope_guard(tscope):
        exe = tf.Executor(tf.CPUPlace())
        tr = [exe.run(tm, feed=f, fetch_list=[tl, "table@GRAD"])
              for f in feeds]
        ttable = tscope.numpy("table")
    np.testing.assert_allclose([float(r[0][0]) for r in tr],
                               [float(np.ravel(r[0])[0]) for r in jr],
                               **TOL)
    np.testing.assert_allclose(ttable, jtable, **TOL)
    np.testing.assert_array_equal(ttable[H - 2:], start["table"][H - 2:])
    for (_, g), (_, jg), f in zip(tr, jr, feeds):
        jg = jg.item() if isinstance(jg, np.ndarray) else jg
        assert isinstance(g, TSR) and g.rows.device.type == "cpu"
        np.testing.assert_array_equal(
            np.sort(g.rows.numpy()),
            np.sort(np.concatenate([f["a"].ravel(), f["b"].ravel()])))
        np.testing.assert_array_equal(g.rows.numpy(), np.asarray(jg.rows))
        np.testing.assert_allclose(g.values.numpy(), np.asarray(jg.values),
                                   **TOL)

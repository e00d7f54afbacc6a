"""The static LAC tagger (tests/torch_static_lac.py) built by both
packages through their fluid entry points, at a small size (vocabulary
200, embedding 16, GRU hidden 16 over 2 bidirectional layers, 7 tags,
batch 4 x 12, uneven lengths): both programs have the same ops,
variables, shapes and dtypes; from the reference's startup values
(carried across by name) 3 SGD steps give the same losses, parameters
and EMA variables (rtol 1e-5 / atol 1e-6); crf_decoding under
ema.apply gives the reference's paths exactly; the embedding's
gradient is a SelectedRows of the batch's ids, and the rows no id
touches keep their bits."""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch as pt
from paddle_tpu import fluid as jfluid
from paddle_tpu.fluid.scope import Scope as JScope
from paddle_tpu.fluid.scope import scope_guard as jscope_guard
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import (CPUPlace, Executor, scope_from_numpy,
                                    scope_guard)
from paddle_tpu_torch.fluid.selected_rows import SelectedRows
from torch_static_lac import LacConfig, build_lac_program, lac_batch

CFG = LacConfig.small(lr=0.5, ema_decay=0.9)
TOL = dict(rtol=1e-5, atol=1e-6)
STEPS = 3


def _ops(prog):
    return [(op.type, sorted((k, tuple(v)) for k, v in op.inputs.items()),
             sorted((k, tuple(v)) for k, v in op.outputs.items()))
            for op in prog.global_block().ops]


def _vars(prog):
    return [(v.name, v.shape, v.dtype, v.persistable, v.stop_gradient)
            for v in prog.list_vars()]


@pytest.mark.parametrize("which", ["main", "startup"])
def test_both_packages_build_the_same_program(which):
    ref = getattr(build_lac_program(jfluid, paddle_tpu, CFG), which)
    port = getattr(build_lac_program(tfluid, pt, CFG), which)
    assert _ops(port) == _ops(ref)
    assert _vars(port) == _vars(ref)
    for oa, ob in zip(ref.global_block().ops, port.global_block().ops):
        assert set(ob.attrs) == set(oa.attrs), oa.type


def test_the_program_is_lac():
    p = build_lac_program(tfluid, pt, CFG)
    types = [op.type for op in p.main.global_block().ops]
    rnn = next(op for op in p.main.global_block().ops if op.type == "rnn")
    assert (rnn.attrs["mode"], rnn.attrs["num_layers"],
            rnn.attrs["is_bidirec"]) == ("GRU", 2, True)
    emb = next(op for op in p.main.global_block().ops
               if op.type == "lookup_table_v2")
    assert emb.attrs["is_sparse"]
    for t in ("linear_chain_crf", "linear_chain_crf_grad", "crf_decoding",
              "rnn_grad", "lookup_table_v2_grad"):
        assert t in types
    params = p.main.all_parameters()
    assert types.count("sgd") == len(params) == 4 * 2 * 2 + 1 + 2 + 1
    assert types.count("sum") == len(params)     # one EMA update each


def _reference(steps=STEPS):
    p = build_lac_program(jfluid, paddle_tpu, CFG)
    feed = lac_batch(CFG, seed=0)
    scope = JScope()
    with jscope_guard(scope):
        exe = jfluid.Executor()
        exe.run(p.startup)
        start = {n: np.asarray(scope.find_var(n)).copy()
                 for n in scope.local_var_names()}
        losses = [float(exe.run(p.main, feed=feed,
                                fetch_list=[p.loss])[0][0])
                  for _ in range(steps)]
        end = {n: np.asarray(scope.find_var(n)) for n in start}
        with p.ema.apply(exe):
            path = np.asarray(exe.run(p.main, feed=feed,
                                      fetch_list=[p.path],
                                      use_prune=True)[0])
    return start, losses, end, path, feed


@pytest.fixture(scope="module")
def reference():
    return _reference()


def test_three_sgd_steps_match_the_reference(reference):
    start, jl, jend, jpath, feed = reference
    p = build_lac_program(tfluid, pt, CFG)
    scope = scope_from_numpy(start, CPUPlace())
    with scope_guard(scope):
        exe = Executor(CPUPlace())
        tl = [float(exe.run(p.main, feed=feed, fetch_list=[p.loss])[0][0])
              for _ in range(STEPS)]
        trained = scope.numpy(p.emb).copy()
        with p.ema.apply(exe):
            # the decoding alone: the pruned program runs no update
            path = exe.run(p.main, feed=feed, fetch_list=[p.path],
                           use_prune=True)[0]
            np.testing.assert_array_equal(scope.numpy(p.emb),
                                          scope.numpy(p.emb + "_ema_0"))
        # apply's block put the trained weights back
        np.testing.assert_array_equal(scope.numpy(p.emb), trained)
    np.testing.assert_allclose(tl, jl, **TOL)
    assert tl[-1] < tl[0]
    emas = [n for n in jend if n.endswith("_ema_0")]
    assert len(emas) == len(p.main.all_parameters())
    for n, v in jend.items():
        np.testing.assert_allclose(scope.numpy(n), v, err_msg=n, **TOL)
    np.testing.assert_array_equal(path, jpath)
    assert path.shape == (CFG.batch, CFG.seq)
    assert (path[np.arange(CFG.seq)[None] >= feed["length"][:, None]]
            == 0).all()


def test_the_embedding_gradient_is_sparse_and_untouched_rows_keep_bits(
        reference):
    start, *_, feed = reference
    p = build_lac_program(tfluid, pt, CFG)
    scope = scope_from_numpy(start, CPUPlace())
    with scope_guard(scope):
        exe = Executor(CPUPlace())
        before = scope.numpy(p.emb).copy()
        g, = exe.run(p.main, feed=feed, fetch_list=[p.emb + "@GRAD"])
        after = scope.numpy(p.emb)
    assert isinstance(g, SelectedRows)
    assert g.height == CFG.vocab and g.rows.dtype == torch.int64
    np.testing.assert_array_equal(g.rows.numpy(), feed["word"].reshape(-1))
    assert tuple(g.values.shape) == (CFG.batch * CFG.seq, CFG.emb)
    touched = np.zeros(CFG.vocab, bool)
    touched[feed["word"].reshape(-1)] = True
    np.testing.assert_array_equal(after[~touched], before[~touched])
    # every word inside a sequence moved (0 pads past the lengths)
    live = np.arange(CFG.seq)[None] < feed["length"][:, None]
    words = np.unique(feed["word"][live])
    assert 0 not in words
    assert (after[words] != before[words]).any(axis=1).all()

"""The static BERT pretraining program (paddle_tpu_torch/models/
bert_static.py) built by both packages through their public static entry
points, at a small size: 2 layers, H 64, 4 heads, I 256, vocab 128,
sequence 16, batch 2, a padding mask, layer 1 with the activation
dropout (the composed FFN and fused_dropout_add_ln). Both programs have
the same ops, variables, shapes and dtypes; from the reference's startup
values (carried across by name) 3 Lamb steps at dropout 0 give the same
losses, parameters and Lamb moments (rtol 1e-4 / atol 1e-6); at dropout
0.1 the port's run is finite and the same from the same seed."""
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest

import paddle_tpu
from paddle_tpu import common_ops as jco
from paddle_tpu.fluid import Executor as JExecutor
from paddle_tpu.fluid import framework as jfw
from paddle_tpu.fluid import initializer as jinit
from paddle_tpu.fluid import layers as jlayers
from paddle_tpu.fluid import optimizer as jopt
from paddle_tpu.fluid import param_attr as jpa
from paddle_tpu.fluid import unique_name as jun
from paddle_tpu.fluid.scope import Scope as JScope
from paddle_tpu.fluid.scope import scope_guard as jscope_guard
import paddle_tpu.ops.flash_attention  # noqa: F401  (fused_attention)
from paddle_tpu_torch.fluid import (CPUPlace, Executor, Scope,
                                    scope_from_numpy, scope_guard)
from paddle_tpu_torch.models.bert_static import (
    BertConfig, bert_pretrain_batch, build_bert_pretrain_program)

JAPI = SimpleNamespace(
    enable_static=paddle_tpu.enable_static,
    disable_static=paddle_tpu.disable_static, framework=jfw,
    layers=jlayers, run_op=jco.run_op, run_op_multi=jco.run_op_multi,
    optimizer=jopt, initializer=jinit, ParamAttr=jpa.ParamAttr,
    unique_name=jun)
CFG = BertConfig(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                 num_attention_heads=4, intermediate_size=256,
                 max_position_embeddings=32)
B, S, M = 2, 16, 5
TOL = dict(rtol=1e-4, atol=1e-6)


def _build(api=None, dropout=0.0, act_dropout=0.0):
    return build_bert_pretrain_program(CFG, B, S, M, lr=1e-3,
                                       dropout=dropout,
                                       act_dropout_layers=(1,),
                                       act_dropout=act_dropout, api=api)


def _ops(prog):
    return [(op.type, sorted((k, tuple(v)) for k, v in op.inputs.items()),
             sorted((k, tuple(v)) for k, v in op.outputs.items()))
            for op in prog.global_block().ops]


def _vars(prog):
    return [(v.name, v.shape, v.dtype, v.persistable, v.stop_gradient)
            for v in prog.list_vars()]


@pytest.mark.parametrize("which", [0, 1])
def test_both_packages_build_the_same_program(which):
    ref, port = _build(JAPI, 0.1, 0.1), _build(None, 0.1, 0.1)
    a, b = ref[which], port[which]
    assert _ops(b) == _ops(a)
    assert _vars(b) == _vars(a)
    for oa, ob in zip(a.global_block().ops, b.global_block().ops):
        assert set(ob.attrs) == set(oa.attrs), oa.type


def test_the_program_spells_bert_with_the_fused_ops():
    main = _build()[0]
    n = Counter(op.type for op in main.global_block().ops)
    L = CFG.num_hidden_layers
    assert n["lookup_table_v2"] == 3 and n["lookup_table_v2_grad"] == 3
    assert n["fused_attention"] == n["fused_attention_grad"] == L
    assert n["fused_out_ln"] == n["fused_out_ln_grad"] == L
    # layer 1 takes the composed FFN with its activation dropout
    assert n["fused_ffn_block"] == n["fused_ffn_block_grad"] == L - 1
    assert n["fused_dropout_add_ln"] == n["fused_dropout_add_ln_grad"] == 1
    assert n["layer_norm"] == n["layer_norm_grad"] == 2
    assert n["lamb"] == len(main.all_parameters())
    assert n["truncated_gaussian_random"] == 0
    startup = _build()[1]
    assert Counter(op.type for op in startup.global_block().ops)[
        "truncated_gaussian_random"] > 0


def _reference_run(steps=3):
    main, startup, loss = _build(JAPI)
    feed = bert_pretrain_batch(CFG, B, S, M, seed=0)
    scope = JScope()
    with jscope_guard(scope):
        exe = JExecutor()
        exe.run(startup)
        start = {n: np.asarray(scope.find_var(n)).copy()
                 for n in scope.local_var_names()}
        losses = [float(exe.run(main, feed=feed, fetch_list=[loss])[0][0])
                  for _ in range(steps)]
        end = {n: np.asarray(scope.find_var(n)) for n in start}
    return start, losses, end, feed


def test_three_lamb_steps_match_the_reference():
    start, jl, jend, feed = _reference_run()
    main, _, loss = _build()
    scope = scope_from_numpy(start, CPUPlace())
    with scope_guard(scope):
        exe = Executor(CPUPlace())
        tl = [float(exe.run(main, feed=feed, fetch_list=[loss])[0][0])
              for _ in range(3)]
    np.testing.assert_allclose(tl, jl, **TOL)
    assert tl[-1] < tl[0]
    moments = [n for n in jend if "_moment" in n]
    assert len(moments) == 2 * len(main.all_parameters())
    for n, v in jend.items():
        np.testing.assert_allclose(scope.find_var(n).numpy(), v,
                                   err_msg=n, **TOL)


def test_dropout_run_is_finite_and_reproducible():
    main, startup, loss = _build(dropout=0.1, act_dropout=0.1)
    main.random_seed = startup.random_seed = 5
    feed = bert_pretrain_batch(CFG, B, S, M, seed=1)
    runs = []
    for _ in range(2):
        with scope_guard(Scope()):
            exe = Executor(CPUPlace())
            exe.run(startup)
            runs.append([float(exe.run(main, feed=feed,
                                       fetch_list=[loss])[0][0])
                         for _ in range(2)])
    assert all(np.isfinite(runs[0]))
    assert runs[0] == runs[1]
    # dropout changes the loss from the p = 0 program's on the same values
    with scope_guard(Scope()):
        exe = Executor(CPUPlace())
        exe.run(startup)
        m0, _, l0 = _build()
        p0 = float(exe.run(m0, feed=feed, fetch_list=[l0])[0][0])
    assert p0 != runs[0][0]

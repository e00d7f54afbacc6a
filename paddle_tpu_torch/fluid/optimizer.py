"""Static-graph optimizers (counterpart of
``paddle_tpu/fluid/optimizer.py``; ported: the ``Optimizer`` base, Adam
and SGD).

`minimize` = append_backward + apply_gradients (one optimizer op per
parameter; regularization and gradient clipping raise
NotImplementedError until ``regularizer.py`` and ``clip.py`` are
ported). Accumulators are persistable global
variables named as the reference names them
(``<param>_moment1_0``, ``<param>_beta1_pow_acc_0``) and initialised by
the startup program. The update ops run in place on the scope's
tensors (``ops/optimizer_ops.py``). Where the update ops begin is
recorded on the program with the gradients they read
(``Program._grad_syncs``): a data-parallel run all-reduces those
gradients there.

Every other optimizer class of the reference (Momentum, Adagrad,
Adamax, RMSProp, Adadelta, Lamb, Ftrl, DecayedAdagrad, the meta
optimizers) raises NotImplementedError: it comes with the rest of the
op library, whose update ops it appends (ROADMAP.md A, item 11).
"""
from __future__ import annotations

from . import unique_name
from .backward import append_backward
from .framework import Variable, default_main_program, in_dygraph_mode
from .layer_helper import LayerHelper

__all__ = ["Optimizer", "Adam", "AdamOptimizer"] + [
    "SGD", "SGDOptimizer", "Momentum", "MomentumOptimizer", "Adagrad",
    "AdagradOptimizer", "Adamax", "AdamaxOptimizer", "RMSProp",
    "RMSPropOptimizer", "Adadelta", "AdadeltaOptimizer", "Lamb",
    "LambOptimizer", "Ftrl", "FtrlOptimizer", "DecayedAdagrad",
    "DecayedAdagradOptimizer"]


class Optimizer:
    def __init__(self, learning_rate=0.001, parameter_list=None,
                 regularization=None, grad_clip=None, name=None):
        if regularization is not None or grad_clip is not None:
            raise NotImplementedError(
                "regularization and grad_clip (fluid/regularizer.py, "
                "fluid/clip.py) come in a later PR of slice 4 (ROADMAP.md "
                "A, item 12)")
        self._learning_rate = learning_rate
        self._parameter_list = parameter_list
        self._name = name
        self._accumulators: dict[str, dict[str, Variable]] = {}
        self._lr_var = None
        self.type = getattr(self, "type", "sgd")

    # -- learning rate -----------------------------------------------------
    def _create_global_learning_rate(self):
        if isinstance(self._learning_rate, Variable):
            self._lr_var = self._learning_rate
            return
        if self._lr_var is not None:
            return
        helper = LayerHelper("learning_rate")
        self._lr_var = helper.create_global_variable(
            name=unique_name.generate("learning_rate"), shape=[1],
            dtype="float32", persistable=True,
            value=float(self._learning_rate))

    # -- accumulators --------------------------------------------------------
    def _add_accumulator(self, name, param, dtype=None, fill_value=0.0,
                         shape=None):
        if name in self._accumulators and \
                param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        helper = LayerHelper(name)
        var = helper.create_global_variable(
            name=unique_name.generate(f"{param.name}_{name}"),
            shape=shape or list(param.shape), dtype=dtype or "float32",
            persistable=True, value=float(fill_value))
        self._accumulators.setdefault(name, {})[param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    # -- main entry points ---------------------------------------------------
    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        parameter_list = parameter_list or self._parameter_list
        return append_backward(loss, parameter_list, no_grad_set, callbacks)

    def apply_gradients(self, params_grads):
        params_grads = [pg for pg in params_grads if pg[1] is not None]
        if any(p.regularizer is not None for p, _ in params_grads):
            raise NotImplementedError(
                "a parameter regularizer (fluid/regularizer.py) comes in a "
                "later PR of slice 4 (ROADMAP.md A, item 12)")
        return self._apply_optimize_ops(params_grads)

    def _apply_optimize_ops(self, params_grads):
        self._create_global_learning_rate()
        self._create_accumulators(
            default_main_program().current_block(),
            [p for p, _ in params_grads])
        block = default_main_program().current_block()
        first = len(block.ops)
        ops = []
        for p, g in params_grads:
            ops.append(self._append_optimize_op(
                default_main_program().current_block(), (p, g)))
        if block.idx == 0 and len(block.ops) > first:
            block.program._grad_syncs.append(
                (first, [g.name for _, g in params_grads]))
        self._finish_update(default_main_program().current_block(),
                            params_grads)
        return ops

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        if in_dygraph_mode():
            raise RuntimeError(
                "fluid optimizers minimize static programs: call "
                "paddle_tpu_torch.enable_static() first (the eager "
                "optimizers are paddle_tpu_torch.jit.make_train_step's)")
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        optimize_ops = self.apply_gradients(params_grads)
        return optimize_ops, params_grads

    # subclass hooks
    def _create_accumulators(self, block, parameters):
        pass

    def _finish_update(self, block, params_grads):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError


class AdamOptimizer(Optimizer):
    type = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=1.0,
                                  shape=[1])
            self._add_accumulator("beta2_pow_acc", p, fill_value=1.0,
                                  shape=[1])

    def _adam_inputs(self, p, g):
        return {"Param": [p], "Grad": [g],
                "LearningRate": [self._lr_var],
                "Moment1": [self._get_accumulator("moment1", p)],
                "Moment2": [self._get_accumulator("moment2", p)],
                "Beta1Pow": [self._get_accumulator("beta1_pow_acc", p)],
                "Beta2Pow": [self._get_accumulator("beta2_pow_acc", p)]}

    def _adam_outputs(self, p):
        return {"ParamOut": [p.name],
                "Moment1Out": [self._get_accumulator("moment1", p).name],
                "Moment2Out": [self._get_accumulator("moment2", p).name],
                "Beta1PowOut": [self._get_accumulator("beta1_pow_acc", p).name],
                "Beta2PowOut": [self._get_accumulator("beta2_pow_acc", p).name]}

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            type="adam", inputs=self._adam_inputs(p, g),
            outputs=self._adam_outputs(p),
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})


class SGDOptimizer(Optimizer):
    type = "sgd"

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            type="sgd",
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._lr_var]},
            outputs={"ParamOut": [p.name]})


def _not_ported(name: str):
    class _NotPorted(Optimizer):
        def __init__(self, *args, **kwargs):
            raise NotImplementedError(
                f"fluid.optimizer.{name} is not ported to paddle_tpu_torch "
                f"yet: it comes with the rest of the op library in a later "
                f"PR of slice 4 (ROADMAP.md A, item 11); Adam and SGD are "
                f"ported")
    _NotPorted.__name__ = _NotPorted.__qualname__ = name
    return _NotPorted


MomentumOptimizer = _not_ported("MomentumOptimizer")
AdagradOptimizer = _not_ported("AdagradOptimizer")
AdamaxOptimizer = _not_ported("AdamaxOptimizer")
RMSPropOptimizer = _not_ported("RMSPropOptimizer")
AdadeltaOptimizer = _not_ported("AdadeltaOptimizer")
LambOptimizer = _not_ported("LambOptimizer")
FtrlOptimizer = _not_ported("FtrlOptimizer")
DecayedAdagradOptimizer = _not_ported("DecayedAdagradOptimizer")

# 2.0-style short aliases
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
RMSProp = RMSPropOptimizer
Adadelta = AdadeltaOptimizer
Lamb = LambOptimizer
Ftrl = FtrlOptimizer
DecayedAdagrad = DecayedAdagradOptimizer

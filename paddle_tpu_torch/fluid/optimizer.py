"""Static-graph optimizers (counterpart of
``paddle_tpu/fluid/optimizer.py``): the ``Optimizer`` base and SGD,
Momentum, Adagrad, Adam, Adamax, RMSProp, Adadelta, Lamb, Ftrl,
DecayedAdagrad and LarsMomentum.

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

The reference's other classes raise NotImplementedError naming where
they are queued: DGCMomentum, GradientMerge, LocalSGD, Lookahead,
ModelAverage and ExponentialMovingAverage in a later PR of item 11 (the
update ops they append exist; the classes' program rewrites do not),
Recompute with the sub-block executor (item 12).
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
    "DecayedAdagradOptimizer", "LarsMomentumOptimizer",
    "DGCMomentumOptimizer", "GradientMergeOptimizer", "LocalSGDOptimizer",
    "LookaheadOptimizer", "ModelAverage", "ExponentialMovingAverage",
    "RecomputeOptimizer"]


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


class _OneOpOptimizer(Optimizer):
    """An optimizer that appends one update op a parameter: `_accs` lists
    (accumulator name, op slot, fill value); `_op_attrs()` its attrs;
    each accumulator's output slot is its slot + "Out" unless `_outs`
    renames it."""
    _accs: tuple = ()
    _outs: dict = {}
    _uses_lr = True

    def _op_attrs(self):
        return {}

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            for name, _, fill in self._accs:
                self._add_accumulator(name, p, fill_value=fill)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        inputs = {"Param": [p], "Grad": [g]}
        outputs = {"ParamOut": [p.name]}
        for name, slot, _ in self._accs:
            acc = self._get_accumulator(name, p)
            inputs[slot] = [acc]
            outputs[self._outs.get(slot, slot + "Out")] = [acc.name]
        if self._uses_lr:
            inputs["LearningRate"] = [self._lr_var]
        return block.append_op(type=self.type, inputs=inputs,
                               outputs=outputs, attrs=self._op_attrs())


class MomentumOptimizer(_OneOpOptimizer):
    type = "momentum"
    _accs = (("velocity", "Velocity", 0.0),)

    def __init__(self, learning_rate, momentum=0.9, use_nesterov=False,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _op_attrs(self):
        return {"mu": self._momentum, "use_nesterov": self._use_nesterov}


class AdagradOptimizer(_OneOpOptimizer):
    type = "adagrad"

    def __init__(self, learning_rate, epsilon=1e-6,
                 initial_accumulator_value=0.0, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._epsilon = epsilon
        self._accs = (("moment", "Moment", initial_accumulator_value),)

    def _op_attrs(self):
        return {"epsilon": self._epsilon}


class AdamaxOptimizer(_OneOpOptimizer):
    """Adamax; its beta1 power is advanced by a scale op a parameter
    after the update ops (``_finish_update``), as in the reference."""
    type = "adamax"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1,
                                  shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            type="adamax",
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._lr_var],
                    "Moment": [self._get_accumulator("moment", p)],
                    "InfNorm": [self._get_accumulator("inf_norm", p)],
                    "Beta1Pow": [self._get_accumulator("beta1_pow_acc", p)]},
            outputs={"ParamOut": [p.name],
                     "MomentOut": [self._get_accumulator("moment", p).name],
                     "InfNormOut": [
                         self._get_accumulator("inf_norm", p).name]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})

    def _finish_update(self, block, params_grads):
        for p, _ in params_grads:
            b1p = self._get_accumulator("beta1_pow_acc", p)
            block.append_op(type="scale", inputs={"X": [b1p]},
                            outputs={"Out": [b1p.name]},
                            attrs={"scale": self._beta1})


class RMSPropOptimizer(_OneOpOptimizer):
    type = "rmsprop"
    _accs = (("mean_square", "MeanSquare", 0.0),
             ("momentum_acc", "Moment", 0.0),
             ("mean_grad", "MeanGrad", 0.0))

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _op_attrs(self):
        return {"decay": self._rho, "epsilon": self._epsilon,
                "momentum": self._momentum, "centered": self._centered}


class AdadeltaOptimizer(_OneOpOptimizer):
    type = "adadelta"
    _accs = (("avg_squared_grad", "AvgSquaredGrad", 0.0),
             ("avg_squared_update", "AvgSquaredUpdate", 0.0))
    _uses_lr = False

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._rho, self._epsilon = rho, epsilon

    def _op_attrs(self):
        return {"rho": self._rho, "epsilon": self._epsilon}


class LambOptimizer(AdamOptimizer):
    """Lamb: Adam's accumulators and one ``lamb`` op a parameter;
    `exclude_from_weight_decay_fn(param)` true gives that parameter
    weight decay 0."""
    type = "lamb"

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6,
                 exclude_from_weight_decay_fn=None, **kwargs):
        super().__init__(learning_rate, beta1, beta2, epsilon, **kwargs)
        self._weight_decay = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        wd = 0.0 if (self._exclude_fn and self._exclude_fn(p)) \
            else self._weight_decay
        return block.append_op(
            type="lamb", inputs=self._adam_inputs(p, g),
            outputs=self._adam_outputs(p),
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon, "weight_decay": wd})


class FtrlOptimizer(_OneOpOptimizer):
    type = "ftrl"
    _accs = (("squared", "SquaredAccumulator", 0.0),
             ("linear", "LinearAccumulator", 0.0))
    _outs = {"SquaredAccumulator": "SquaredAccumOut",
             "LinearAccumulator": "LinearAccumOut"}

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _op_attrs(self):
        return {"l1": self._l1, "l2": self._l2, "lr_power": self._lr_power}


class DecayedAdagradOptimizer(_OneOpOptimizer):
    type = "decayed_adagrad"
    _accs = (("moment", "Moment", 0.0),)

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._decay, self._epsilon = decay, epsilon

    def _op_attrs(self):
        return {"decay": self._decay, "epsilon": self._epsilon}


class LarsMomentumOptimizer(_OneOpOptimizer):
    """LARS: the lr of each parameter scaled by
    ||param|| / (||grad|| + wd * ||param||)."""
    type = "lars_momentum"
    _accs = (("velocity", "Velocity", 0.0),)

    def __init__(self, learning_rate, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, epsilon=0.0, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay
        self._epsilon = epsilon

    def _op_attrs(self):
        return {"mu": self._momentum, "lars_coeff": self._lars_coeff,
                "lars_weight_decay": self._lars_weight_decay,
                "epsilon": self._epsilon}


def _not_ported(name: str, where: str):
    class _NotPorted:
        def __init__(self, *args, **kwargs):
            raise NotImplementedError(
                f"fluid.optimizer.{name} is not ported to paddle_tpu_torch "
                f"yet: it comes {where}")
    _NotPorted.__name__ = _NotPorted.__qualname__ = name
    return _NotPorted


_LATER_11 = ("in a later PR of ROADMAP.md A, item 11 (its update ops are "
             "ported; the program rewrite that drives them is not)")
DGCMomentumOptimizer = _not_ported("DGCMomentumOptimizer", _LATER_11)
GradientMergeOptimizer = _not_ported("GradientMergeOptimizer", _LATER_11)
LocalSGDOptimizer = _not_ported("LocalSGDOptimizer", _LATER_11)
LookaheadOptimizer = _not_ported("LookaheadOptimizer", _LATER_11)
ModelAverage = _not_ported("ModelAverage", _LATER_11)
ExponentialMovingAverage = _not_ported("ExponentialMovingAverage",
                                       _LATER_11)
RecomputeOptimizer = _not_ported(
    "RecomputeOptimizer", "with the sub-block executor (ROADMAP.md A, item "
    "12)")

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

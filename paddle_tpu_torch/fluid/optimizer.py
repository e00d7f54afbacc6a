"""Static-graph optimizers (counterpart of
``paddle_tpu/fluid/optimizer.py``): the ``Optimizer`` base and SGD,
Momentum, Adagrad, Adam, Adamax, RMSProp, Adadelta, Lamb, Ftrl,
DecayedAdagrad, LarsMomentum and DGCMomentum; the LocalSGD and
Lookahead wrappers; ExponentialMovingAverage and ModelAverage.

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

The wrappers and averages rewrite the program as the reference's do:
DGCMomentum appends one ``dgc_momentum`` op a parameter; LocalSGD the
inner optimizer's ops, a step counter and one ``localsgd_sync`` a
parameter; ExponentialMovingAverage (``update``) and ModelAverage
(constructed after the training optimizer's minimize) their averaging
ops, and ``apply`` swaps the averages into the scope for a ``with``
block. Lookahead is static here (the reference's is eager only): a
slow copy of each parameter, taken before the first update, and every
k-th step slow += alpha * (fast - slow), fast = slow, as ops.
GradientMerge raises: its ``cond`` over two sub-blocks comes with the
sub-block executor (ROADMAP.md A, item 12), as does Recompute.
"""
from __future__ import annotations

import contextlib

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


class DGCMomentumOptimizer(_OneOpOptimizer):
    """Deep Gradient Compression's momentum: the top ``1 - sparsity`` of
    the accumulated residual applied, the rest kept local; plain
    momentum before ``rampup_begin_step`` (the terminal sparsity
    governs, as in the reference)."""
    type = "dgc_momentum"

    def __init__(self, learning_rate, momentum=0.9, rampup_begin_step=0,
                 rampup_step=1, sparsity=(0.999,), use_nesterov=False,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._rampup_begin_step = float(rampup_begin_step)
        self._ratio = 1.0 - float(sparsity[-1])
        self._use_nesterov = use_nesterov

    def _op_attrs(self):
        return {"mu": self._momentum, "ratio": self._ratio,
                "rampup_begin_step": self._rampup_begin_step,
                "use_nesterov": self._use_nesterov}

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("u_acc", p)
            self._add_accumulator("v_acc", p)
            self._add_accumulator("dgc_step", p, shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        u = self._get_accumulator("u_acc", p)
        v = self._get_accumulator("v_acc", p)
        st = self._get_accumulator("dgc_step", p)
        return block.append_op(
            type="dgc_momentum",
            inputs={"Param": [p], "Grad": [g], "U": [u], "V": [v],
                    "CurrentStep": [st], "LearningRate": [self._lr_var]},
            outputs={"ParamOut": [p.name], "UOut": [u.name],
                     "VOut": [v.name], "CurrentStepOut": [st.name]},
            attrs=self._op_attrs())


class LocalSGDOptimizer(Optimizer):
    """Local SGD: the inner optimizer's update, then on every k-th step
    from ``begin_step`` each parameter becomes its data-parallel average
    (``localsgd_sync``; the identity outside a data-parallel run)."""

    def __init__(self, inner_optimizer, k_steps=1, begin_step=1):
        super().__init__(getattr(inner_optimizer, "_learning_rate", 0.001),
                         parameter_list=getattr(inner_optimizer,
                                                "_parameter_list", None))
        self.inner_optimizer = inner_optimizer
        self.k_steps = int(k_steps)
        self.begin_step = int(begin_step)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        res = self.inner_optimizer.minimize(loss, startup_program,
                                            parameter_list, no_grad_set)
        self._append_sync_ops(res[1])
        return res

    def _append_sync_ops(self, params_grads):
        if not params_grads:
            return
        block = default_main_program().current_block()
        step = LayerHelper("localsgd").create_global_variable(
            name=unique_name.generate("localsgd_step"), shape=[1],
            dtype="float32", persistable=True, value=0.0)
        block.append_op(type="increment", inputs={"X": [step]},
                        outputs={"Out": [step.name]}, attrs={"step": 1.0})
        for p, _g in params_grads:
            block.append_op(
                type="localsgd_sync", inputs={"Param": [p], "Step": [step]},
                outputs={"ParamOut": [p.name]},
                attrs={"k_steps": self.k_steps,
                       "begin_step": self.begin_step})


class LookaheadOptimizer:
    """Lookahead: the inner ("fast") optimizer steps; every k steps the
    slow weights move slow += alpha * (fast - slow) and the fast weights
    reset to them. The slow weights start at the parameters' values
    before the first update. Static: the rewrite is ops of the program
    (a step counter; before the updates, slow = param on step 0; after
    them, the k-th-step blend)."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        if not 0.0 <= alpha <= 1.0:
            raise ValueError("alpha should be in [0, 1]")
        self.inner_optimizer = inner_optimizer
        self.alpha = alpha
        self.k = int(k)
        self._slow: dict[str, Variable] = {}

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        if in_dygraph_mode():
            raise RuntimeError(
                "fluid optimizers minimize static programs: call "
                "paddle_tpu_torch.enable_static() first")
        inner = self.inner_optimizer
        params_grads = inner.backward(loss, startup_program, parameter_list,
                                      no_grad_set)
        helper = LayerHelper("lookahead")
        block = default_main_program().current_block()

        def const(name, value):
            return helper.create_global_variable(
                name=unique_name.generate(name), shape=[1], dtype="float32",
                persistable=True, value=float(value))

        def tmp(dtype="float32"):
            return helper.create_variable_for_type_inference(dtype, True)

        def op(type, inputs, attrs=None, dtype="float32", out=None):
            out = out if out is not None else tmp(dtype)
            block.append_op(type=type, inputs=inputs, outputs={"Out": [out]},
                            attrs=attrs or {})
            return out

        step = const("lookahead_step", 0.0)
        zero, k = const("lookahead_zero", 0.0), const("lookahead_k", self.k)
        first = op("equal", {"X": [step], "Y": [zero]}, dtype="bool")
        for p, _ in params_grads:
            s = helper.create_global_variable(
                name=unique_name.generate(f"{p.name}_slow"),
                shape=list(p.shape), dtype=p.dtype, persistable=True,
                value=0.0)
            self._slow[p.name] = s
            op("where", {"Condition": [first], "X": [p], "Y": [s]}, out=s)
        ops = inner.apply_gradients(params_grads)
        op("increment", {"X": [step]}, {"step": 1.0}, out=step)
        sync = op("equal", {"X": [op("elementwise_mod",
                                     {"X": [step], "Y": [k]})],
                            "Y": [zero]}, dtype="bool")
        for p, _ in params_grads:
            s = self._slow[p.name]
            diff = op("elementwise_sub", {"X": [p], "Y": [s]}, dtype=p.dtype)
            moved = op("elementwise_add",
                       {"X": [s], "Y": [op("scale", {"X": [diff]},
                                           {"scale": float(self.alpha)},
                                           dtype=p.dtype)]}, dtype=p.dtype)
            op("where", {"Condition": [sync], "X": [moved], "Y": [s]},
               out=s)
            op("where", {"Condition": [sync], "X": [moved], "Y": [p]},
               out=p)
        return ops, params_grads


class ExponentialMovingAverage:
    """The exponential moving average of the trainable parameters:
    ``update()`` appends ema = decay * ema + (1 - decay) * param a
    parameter (the averages start at 0, as in the reference);
    ``with ema.apply(exe):`` runs with the averages in the parameters'
    place and puts the parameters back after (``need_restore``)."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = decay
        self._name = name or ""
        self._ema_vars: dict[str, Variable] = {}
        self._params: list = []

    def update(self):
        block = default_main_program().current_block()
        helper = LayerHelper("ema")
        for p in default_main_program().all_parameters():
            if not p.trainable:
                continue
            ema = helper.create_global_variable(
                name=unique_name.generate(f"{p.name}_ema"),
                shape=list(p.shape), dtype=p.dtype, persistable=True,
                value=0.0)
            self._ema_vars[p.name] = ema
            self._params.append(p)
            scaled_p = helper.create_variable_for_type_inference(p.dtype)
            block.append_op(type="scale", inputs={"X": [p]},
                            outputs={"Out": [scaled_p]},
                            attrs={"scale": 1 - self._decay})
            scaled_e = helper.create_variable_for_type_inference(p.dtype)
            block.append_op(type="scale", inputs={"X": [ema]},
                            outputs={"Out": [scaled_e]},
                            attrs={"scale": self._decay})
            block.append_op(type="sum", inputs={"X": [scaled_e, scaled_p]},
                            outputs={"Out": [ema.name]})

    def apply(self, executor=None, need_restore=True):
        return _swapped(
            {p.name: self._ema_vars[p.name].name for p in self._params},
            lambda scope, name: scope.find_var(name), need_restore)

    def restore(self, executor=None):
        pass  # the parameters come back when apply's block exits


class ModelAverage:
    """The average of the parameters over the steps: one
    ``average_accumulates`` op a parameter adds it into running sums
    every step; ``with ma.apply(exe):`` runs with the parameters
    replaced by sum / count. Construct it after the training
    optimizer's minimize, so that the sums follow the updates. One
    running window, as in the reference."""

    def __init__(self, average_window_rate=0.15, min_average_window=10000,
                 max_average_window=10000):
        if in_dygraph_mode():
            raise RuntimeError(
                "ModelAverage averages a static program: call "
                "paddle_tpu_torch.enable_static() first")
        self.average_window = average_window_rate
        self.min_average_window = min_average_window
        self.max_average_window = max_average_window
        self._avg_vars = []
        block = default_main_program().global_block()
        helper = LayerHelper("model_average")

        def gvar(pname, suffix, shape):
            return helper.create_global_variable(
                name=unique_name.generate(f"{pname}_{suffix}"),
                shape=shape, dtype="float32", persistable=True, value=0.0)

        for p in block.all_parameters():
            s1 = gvar(p.name, "sum_1", list(p.shape))
            s2 = gvar(p.name, "sum_2", list(p.shape))
            s3 = gvar(p.name, "sum_3", list(p.shape))
            na = gvar(p.name, "num_accumulates", [1])
            ona = gvar(p.name, "old_num_accumulates", [1])
            nu = gvar(p.name, "num_updates", [1])
            block.append_op(
                type="average_accumulates",
                inputs={"param": [p], "in_sum_1": [s1], "in_sum_2": [s2],
                        "in_sum_3": [s3], "in_num_accumulates": [na],
                        "in_old_num_accumulates": [ona],
                        "in_num_updates": [nu]},
                outputs={"out_sum_1": [s1.name], "out_sum_2": [s2.name],
                         "out_sum_3": [s3.name],
                         "out_num_accumulates": [na.name],
                         "out_old_num_accumulates": [ona.name],
                         "out_num_updates": [nu.name]},
                attrs={"average_window": float(average_window_rate),
                       "min_average_window": int(min_average_window),
                       "max_average_window": int(max_average_window)})
            self._avg_vars.append((p, s1, s2, s3, na, ona))

    def apply(self, executor=None, need_restore=True):
        sums = {p.name: (s1.name, s2.name, s3.name, na.name, ona.name)
                for p, s1, s2, s3, na, ona in self._avg_vars}

        def average(scope, names):
            s1, s2, s3, na, ona = (scope.find_var(n) for n in names)
            n = float(na.reshape(-1)[0]) + float(ona.reshape(-1)[0])
            return (s1 + s2 + s3) / n if n > 0 else None
        return _swapped(sums, average, need_restore)

    def restore(self, executor=None):
        pass  # the parameters come back when apply's block exits


@contextlib.contextmanager
def _swapped(sources: dict, value_of, need_restore: bool):
    """Inside the block each parameter named in `sources` holds
    value_of(scope, sources[name]) (kept when that is None), cast to the
    parameter's dtype; after it, the parameters come back unless
    need_restore is False."""
    from .executor import global_scope
    scope = global_scope()
    backup = {}
    for name, src in sources.items():
        cur = scope.find_var(name)
        if cur is None:
            continue
        val = value_of(scope, src)
        if val is None:
            continue
        backup[name] = cur
        scope.set(name, val.to(cur.dtype))
    try:
        yield
    finally:
        if need_restore:
            for name, val in backup.items():
                scope.set(name, val)


def _not_ported(name: str, where: str):
    class _NotPorted:
        def __init__(self, *args, **kwargs):
            raise NotImplementedError(
                f"fluid.optimizer.{name} is not ported to paddle_tpu_torch "
                f"yet: {where}")
    _NotPorted.__name__ = _NotPorted.__qualname__ = name
    return _NotPorted


GradientMergeOptimizer = _not_ported(
    "GradientMergeOptimizer", "its update runs in a cond op over two "
    "sub-blocks, which comes with the sub-block executor (ROADMAP.md A, "
    "item 12)")
RecomputeOptimizer = _not_ported(
    "RecomputeOptimizer", "it comes with the sub-block executor (ROADMAP.md "
    "A, item 12)")

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

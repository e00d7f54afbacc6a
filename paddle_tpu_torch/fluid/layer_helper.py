"""LayerHelper: shared param-creation / op-append glue for all layers
(counterpart of ``paddle_tpu/fluid/layer_helper.py``).

Creates parameters in the main program's global block AND emits their
init ops into the startup program; appends ops into the current block;
applies activations. Static mode only: eager code in the port is torch
itself (``paddle_tpu_torch.nn``).
"""
from __future__ import annotations

from . import unique_name
from .framework import (default_main_program, default_startup_program,
                        in_dygraph_mode)
from .initializer import ConstantInitializer, XavierInitializer
from .param_attr import ParamAttr

__all__ = ["LayerHelper"]


class LayerHelper:
    def __init__(self, layer_type: str, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        self.name = name or unique_name.generate(layer_type)

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    # -- params ------------------------------------------------------------
    def create_parameter(self, attr, shape, dtype="float32", is_bias=False,
                         default_initializer=None, stop_gradient=False):
        attr = ParamAttr._to_attr(attr)
        if attr is None:
            return None
        if attr.initializer is None:
            attr.initializer = default_initializer or (
                ConstantInitializer(0.0) if is_bias else XavierInitializer())
        suffix = "b" if is_bias else "w"
        name = attr.name or unique_name.generate(f"{self.name}.{suffix}")

        if in_dygraph_mode():
            raise RuntimeError(
                "fluid layers create static-graph parameters: call "
                "paddle_tpu_torch.enable_static() first (eager layers are "
                "paddle_tpu_torch.nn's torch modules)")

        param = self.main_program.global_block().create_parameter(
            name=name, shape=shape, dtype=dtype, trainable=attr.trainable,
            regularizer=attr.regularizer,
            do_model_average=attr.do_model_average, need_clip=attr.need_clip,
            optimize_attr={"learning_rate": attr.learning_rate})
        # mirrored var + init op in the startup program
        sb = self.startup_program.global_block()
        if not sb.has_var(name):
            sv = sb.create_var(name=name, shape=shape, dtype=dtype,
                               persistable=True)
            attr.initializer(sv, sb)
        return param

    def create_variable_for_type_inference(self, dtype="float32",
                                           stop_gradient=False):
        return self.main_program.current_block().create_var(
            name=unique_name.generate(f"{self.name}.tmp"), dtype=dtype,
            stop_gradient=stop_gradient)

    def create_global_variable(self, name=None, shape=(1,), dtype="float32",
                               persistable=False, value=None,
                               stop_gradient=True):
        gb = self.main_program.global_block()
        v = gb.create_var(name=name or unique_name.generate(f"{self.name}.gv"),
                          shape=shape, dtype=dtype, persistable=persistable,
                          stop_gradient=stop_gradient)
        if value is not None:
            sb = self.startup_program.global_block()
            if not sb.has_var(v.name):
                sv = sb.create_var(name=v.name, shape=shape, dtype=dtype,
                                   persistable=persistable)
                ConstantInitializer(value)(sv, sb)
        return v

    # -- ops ---------------------------------------------------------------
    def append_op(self, **kwargs):
        return self.main_program.current_block().append_op(**kwargs)

    def append_activation(self, out_var, act=None):
        act = act if act is not None else self.kwargs.get("act")
        if act is None:
            return out_var
        if isinstance(act, str):
            act = {"type": act}
        act_type = act.pop("type")
        if in_dygraph_mode():
            from ..common_ops import run_op
            return run_op(act_type, {"X": [out_var]}, act)
        tmp = self.create_variable_for_type_inference(dtype=out_var.dtype)
        self.append_op(type=act_type, inputs={"X": [out_var]},
                       outputs={"Out": [tmp]}, attrs=act)
        return tmp

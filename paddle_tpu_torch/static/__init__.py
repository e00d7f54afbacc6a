"""paddle.static namespace (counterpart of ``paddle_tpu/static/``): the
static graph's entry points. ``io`` (save/load inference models),
``CompiledProgram`` and ``static.nn`` wait for later PRs (ROADMAP.md A,
item 12)."""
from __future__ import annotations

from ..fluid import layers as _layers
from ..fluid.backward import append_backward, gradients
from ..fluid.executor import Executor, global_scope, scope_guard
from ..fluid.framework import (Program, Variable, default_main_program,
                               default_startup_program, name_scope,
                               program_guard)
from ..fluid.param_attr import ParamAttr

__all__ = [
    "data", "Executor", "global_scope", "scope_guard", "Program",
    "Variable", "default_main_program", "default_startup_program",
    "program_guard", "name_scope", "append_backward",
    "gradients", "ParamAttr", "accuracy",
]


def data(name, shape, dtype="float32", lod_level=0):
    return _layers.data(name, shape, dtype, lod_level)


accuracy = _layers.accuracy

"""paddle_tpu_torch.fluid — the static graph of the port (counterpart of
``paddle_tpu/fluid/``): the Program IR, the op registry with the ops of
the ported programs, graph-level autodiff, the Adam optimizer, and an
Executor that runs a block op by op on the card (or, when asked, the
CPU)."""
from . import core, framework, initializer, unique_name
from . import ops as _ops  # registers the ported ops
from . import layers
from .backward import append_backward, gradients
from .core import CPUPlace, CUDAPlace, get_flags, set_flags
from .executor import Executor, global_scope, scope_guard
from .framework import (Program, Variable, default_main_program,
                        default_startup_program, disable_dygraph,
                        enable_dygraph, in_dygraph_mode, name_scope,
                        program_guard)
from .initializer import Constant, Normal, Uniform, Xavier
from . import optimizer
from .param_attr import ParamAttr
from .scope import Scope, scope_from_numpy

__all__ = [
    "core", "framework", "layers", "initializer", "optimizer",
    "unique_name", "CPUPlace", "CUDAPlace", "Executor", "Program",
    "Variable", "default_main_program", "default_startup_program",
    "program_guard", "append_backward", "gradients", "ParamAttr",
    "global_scope", "scope_guard", "Scope", "scope_from_numpy",
    "name_scope", "in_dygraph_mode", "get_flags",
    "set_flags", "enable_dygraph", "disable_dygraph",
]

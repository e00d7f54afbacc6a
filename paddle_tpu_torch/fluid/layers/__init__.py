"""fluid.layers namespace (counterpart of ``paddle_tpu/fluid/layers/``),
as far as the ported programs reach."""
from . import nn, tensor
from .math_op_patch import monkey_patch_variable
monkey_patch_variable()
from .nn import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403

from .nn import __all__ as _nn_all
from .tensor import __all__ as _tensor_all

__all__ = list(_nn_all) + list(_tensor_all)

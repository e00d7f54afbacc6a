"""Parameter initializers — append init ops to the startup program
(counterpart of ``paddle_tpu/fluid/initializer.py``; ported: Constant,
Uniform, Normal, Xavier).

Initialisation runs as ops of the startup Program, as in the reference.
The random ops draw from a ``torch.Generator`` seeded per op from (run
seed, the op's ``_rng_id``), so they match the reference in distribution,
not in value: a test that needs the reference's exact weights carries
its scope across (``scope.scope_from_numpy``).
"""
from __future__ import annotations

import math

import numpy as np

__all__ = [
    "Initializer", "Constant", "Uniform", "Normal", "Xavier",
    "ConstantInitializer", "UniformInitializer", "NormalInitializer",
    "XavierInitializer",
]


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError

    def _fan_in_out(self, var):
        shape = var.shape
        if len(shape) < 2:
            return (shape[0] if shape else 1,) * 2
        recep = int(np.prod(shape[2:])) if len(shape) > 2 else 1
        return shape[1] * recep, shape[0] * recep


class ConstantInitializer(Initializer):
    def __init__(self, value: float = 0.0, force_cpu: bool = False):
        self.value = value

    def __call__(self, var, block):
        return block.append_op(
            type="fill_constant", outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "value": float(self.value),
                   "dtype": var.dtype})


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        return block.append_op(
            type="uniform_random", outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "min": self.low,
                   "max": self.high, "seed": self.seed, "dtype": var.dtype})


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            type="gaussian_random", outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "mean": self.loc,
                   "std": self.scale, "seed": self.seed, "dtype": var.dtype})


class XavierInitializer(Initializer):
    """Glorot. fan_in/fan_out from the param shape (conv-aware)."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out, self.seed = \
            uniform, fan_in, fan_out, seed

    def __call__(self, var, block):
        fi, fo = self._fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            return UniformInitializer(-limit, limit, self.seed)(var, block)
        std = math.sqrt(2.0 / (fi + fo))
        return NormalInitializer(0.0, std, self.seed)(var, block)


# reference-style aliases
Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer


def _global_weight_initializer():
    return XavierInitializer()


def _global_bias_initializer():
    return ConstantInitializer(0.0)

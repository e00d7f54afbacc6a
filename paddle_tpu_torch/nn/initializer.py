"""Parameter initialisers (counterpart of the ``Normal`` initialiser of
``paddle_tpu/nn/initializer`` and the defaults of
``paddle_tpu/fluid/initializer.py``).

Each initialiser fills a tensor in place from a ``torch.Generator``; the
default generator is the module's own, reseeded with ``seed(n)``. The
reference draws from ``jax.random``, so the port's values match the
reference's in distribution only; parity tests carry the reference's
weights across instead (``models.bert.params_from_jax``,
``models.resnet.params_from_jax``). Defaults, as the reference's: a
Linear weight ``XavierUniform``, a Conv2D filter
``Normal(0, sqrt(2 / (kh kw in_channels)))``, biases ``Constant(0)``.
"""
from __future__ import annotations

import math

import torch

__all__ = ["Normal", "XavierUniform", "Constant", "seed",
           "default_generator"]

_generator = torch.Generator().manual_seed(0)


def seed(n: int) -> None:
    """Reseed the generator that initialisers use by default."""
    _generator.manual_seed(int(n))


def default_generator() -> torch.Generator:
    return _generator


class Normal:
    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean, self.std = mean, std

    def __call__(self, t, generator=None):
        with torch.no_grad():
            return t.normal_(self.mean, self.std,
                             generator=generator or _generator)


class XavierUniform:
    """The reference's default for a Linear weight (in, out): uniform in
    +-sqrt(6 / (fan_in + fan_out))."""

    def __call__(self, t, generator=None):
        fan_in, fan_out = t.shape[0], t.shape[1]
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        with torch.no_grad():
            return t.uniform_(-limit, limit,
                              generator=generator or _generator)


class Constant:
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, t, generator=None):
        with torch.no_grad():
            return t.fill_(self.value)

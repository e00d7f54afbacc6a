"""Scope: host-side name -> tensor store (counterpart of
``paddle_tpu/fluid/scope.py``, the reference's framework/scope.h).

Values are torch tensors on the executor's device. The reference's
child scopes (``new_scope``) serve control-flow sub-blocks, which are not
ported; the port's scope is one flat table.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from . import core

__all__ = ["Scope", "global_scope", "scope_guard", "scope_from_numpy"]


class Scope:
    def __init__(self):
        self._vars: dict = {}

    def find_var(self, name: str):
        return self._vars.get(name)

    def has(self, name: str) -> bool:
        return name in self._vars

    def set(self, name: str, value):
        self._vars[name] = value

    def local_var_names(self) -> list[str]:
        return list(self._vars)

    def numpy(self, name: str) -> np.ndarray:
        v = self.find_var(name)
        if v is None:
            raise KeyError(name)
        return core.batched_to_numpy([v])[0]


def scope_from_numpy(arrays: dict, place=None) -> Scope:
    """A Scope holding `arrays` ({name: numpy array}, e.g. a reference
    scope dumped by name) as tensors on `place`'s device (default: the
    first card, which raises without one). Integer arrays keep their
    type; int32 values stay int32."""
    dev = (place or core.default_place()).torch_device()
    scope = Scope()
    for name, arr in arrays.items():
        scope.set(name, torch.as_tensor(np.array(arr, copy=True), device=dev))
    return scope


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope: Scope):
    global _global_scope
    old, _global_scope = _global_scope, scope
    try:
        yield
    finally:
        _global_scope = old

"""Unique name generator for graph variables/ops (counterpart of
``paddle_tpu/fluid/unique_name.py``, the same rule, so both packages
name a program's variables alike): a per-prefix counter with guard
support for deterministic re-tracing.
"""
from __future__ import annotations

import contextlib


class UniqueNameGenerator:
    def __init__(self, prefix: str = ""):
        self.prefix = prefix
        self.ids: dict[str, int] = {}

    def __call__(self, key: str) -> str:
        i = self.ids.get(key, 0)
        self.ids[key] = i + 1
        return self.prefix + "_".join([key, str(i)])


generator = UniqueNameGenerator()


def generate(key: str) -> str:
    return generator(key)


@contextlib.contextmanager
def guard(new_prefix: str = ""):
    """Scope the generator so names restart (used by Program.clone, tests)."""
    global generator
    old = generator
    generator = UniqueNameGenerator(new_prefix)
    try:
        yield
    finally:
        generator = old


def switch(new_generator: UniqueNameGenerator | None = None):
    global generator
    old = generator
    generator = new_generator or UniqueNameGenerator()
    return old

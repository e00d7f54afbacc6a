"""Name-pattern -> sharding-spec rules (counterpart of
``paddle_tpu/parallel/sharding.py``).

A spec is a plain tuple with one entry per leading dimension of a
value: None (whole), an axis name, or a tuple of axis names; the
reference's ``PartitionSpec`` has the same meaning. A rule table maps
parameter-name regexes to specs, so one rule set serves an unsharded
run, dp only, or dp x tp. The port has no ``NamedSharding``: a rank
holds its piece of a value (``shard_of``) and the executor or the train
step gathers it back where the whole value is needed.
"""
from __future__ import annotations

import re
from typing import Any, Sequence

import numpy as np

__all__ = ["ShardingRules", "spec_for", "shard_of", "resolve_spec"]


class ShardingRules:
    """Ordered (regex, spec) table; first match wins.

    Axis names in a spec but absent from the mesh (or of size 1) are
    dropped at resolution time, so one rule set serves tp=1 and tp>1
    meshes."""

    def __init__(self, rules: Sequence[tuple[str, tuple]] | None = None,
                 default: tuple = ()):
        self.rules = [(re.compile(pat), tuple(spec))
                      for pat, spec in (rules or [])]
        self.default = tuple(default)

    def spec(self, name: str, mesh=None, ndim: int | None = None) -> tuple:
        spec = self.default
        for pat, s in self.rules:
            if pat.search(name):
                spec = s
                break
        if mesh is not None:
            spec = _restrict(spec, mesh)
        if ndim is not None and len(spec) > ndim:
            raise ValueError(
                f"spec {spec} for {name!r} has more dims than the {ndim}-d "
                f"param")
        return spec


def _sizes(mesh) -> dict:
    return mesh.shape if hasattr(mesh, "shape") else dict(mesh)


def _restrict(spec: tuple, mesh) -> tuple:
    """Drop axis names the mesh doesn't have (or that have size 1)."""
    shape = _sizes(mesh)
    out = []
    for entry in spec:
        if entry is None:
            out.append(None)
        elif isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if shape.get(a, 1) > 1)
            out.append(kept if kept else None)
        else:
            out.append(entry if shape.get(entry, 1) > 1 else None)
    return tuple(out)


def resolve_spec(spec: tuple, mesh, shape) -> tuple:
    """The spec a value of `shape` takes: () when the spec has more
    dimensions than the value (a beta-pow accumulator under its
    weight's rule stays whole), and an entry dropped where its axes do
    not divide the dimension (the reference executor's
    ``_param_sharding``)."""
    sizes = _sizes(mesh)
    spec = _restrict(spec, sizes)
    if len(spec) > len(shape):
        return ()

    def fits(i, entry):
        axes = entry if isinstance(entry, (tuple, list)) else (entry,)
        return shape[i] % int(np.prod([sizes[a] for a in axes])) == 0

    return tuple(e if e is None or fits(i, e) else None
                 for i, e in enumerate(spec))


def spec_for(tree_of_names: Any, rules: ShardingRules, mesh) -> Any:
    """Map a (nested dict / list) tree of param names to their specs."""
    if isinstance(tree_of_names, dict):
        return {k: spec_for(v, rules, mesh)
                for k, v in tree_of_names.items()}
    if isinstance(tree_of_names, (list, tuple)):
        return type(tree_of_names)(spec_for(v, rules, mesh)
                                   for v in tree_of_names)
    return rules.spec(tree_of_names, mesh)


def shard_of(value, spec: tuple, coords: dict, sizes: dict):
    """This rank's piece of `value` (numpy, a memmap or a tensor) under
    `spec`: dimension i cut into sizes[axis] equal parts and part
    coords[axis] kept, for each axis named at i (several axes on one
    dimension cut it row-major, the first outermost). Axes of size 1
    cut nothing."""
    index = []
    for i, entry in enumerate(spec):
        axes = () if entry is None else (
            tuple(entry) if isinstance(entry, (tuple, list)) else (entry,))
        n, k = 1, 0
        for a in axes:
            n, k = n * sizes.get(a, 1), k * sizes.get(a, 1) + coords.get(a, 0)
        if n == 1:
            index.append(slice(None))
            continue
        if value.shape[i] % n:
            raise ValueError(f"dimension {i} of {tuple(value.shape)} does "
                             f"not split into {n} parts ({spec})")
        step = value.shape[i] // n
        index.append(slice(k * step, (k + 1) * step))
    return value[tuple(index)]

"""Global process mesh (counterpart of ``paddle_tpu/distributed/mesh.py``).

The reference's ``Mesh`` lays jax devices out on named axes, and its
collectives name an axis instead of a ring. The port runs one process
per rank, so its ``Mesh`` lays the ranks of the process group out on
named axes, row-major as ``numpy.reshape`` lays out the reference's
devices, and keeps for each axis the process group of the ranks that
share this rank's other coordinates. The groups are made over the
world's backend (``env.init_parallel_env``); ``torch.distributed``'s
``DeviceMesh`` is not used, since for "cuda" it would ask NCCL, which
refuses two ranks on one card.
"""
from __future__ import annotations

import math

import numpy as np
import torch.distributed as dist

from .env import get_rank, get_world_size

__all__ = ["Mesh", "default_mesh", "get_mesh", "set_mesh", "make_mesh"]


class Mesh:
    """Named axes over the ranks of the world. ``shape`` maps each axis
    to its size (the reference's ``mesh.shape``); ``group(axis)`` is the
    process group of this rank's line along it (None when the axis has
    one rank); ``coord(axis)`` is this rank's index on it; ``ranks`` is
    the grid of world ranks. A mesh of one rank holds this rank alone,
    in a world of any size (the reference's mesh over ``devices[:1]``)."""

    def __init__(self, axes: dict[str, int]):
        self.axis_names = tuple(axes)
        self.shape = dict(axes)
        self.size = math.prod(axes.values())
        world = get_world_size()
        if self.size == 1:
            self.ranks = np.full([1] * len(axes), get_rank())
            self._coord = {a: 0 for a in self.axis_names}
            self._groups = {a: None for a in self.axis_names}
            return
        if self.size != world:
            raise ValueError(f"mesh {axes} holds {self.size} ranks; the "
                             f"world has {world}")
        ranks = np.arange(world).reshape([axes[a] for a in self.axis_names])
        self.ranks = ranks
        here = np.argwhere(ranks == get_rank())[0]
        self._coord = {a: int(i) for a, i in zip(self.axis_names, here)}
        self._groups = {}
        for i, name in enumerate(self.axis_names):
            if axes[name] == 1:
                self._groups[name] = None
                continue
            if axes[name] == world:
                self._groups[name] = dist.group.WORLD
                continue
            # every rank makes every group, in one order (new_group is
            # collective over the world); it keeps its own line's
            lines = np.moveaxis(ranks, i, -1).reshape(-1, axes[name])
            for line in lines:
                g = dist.new_group([int(r) for r in line])
                if get_rank() in line:
                    self._groups[name] = g

    def group(self, axis: str):
        return self._groups[axis]

    def joint_group(self, axes) -> object:
        """The process group of the ranks that share this rank's
        coordinates on every axis but `axes` (None when they are one
        rank; an axis's own group when only it has more than one), in
        rank order: the first of `axes` (in mesh order) outermost.
        Collective the first time for a set of axes: every rank asks for
        the same sets in the same order."""
        axes = tuple(a for a in self.axis_names
                     if a in axes and self.shape[a] > 1)
        if len(axes) <= 1:
            return self._groups[axes[0]] if axes else None
        if axes in self._groups:
            return self._groups[axes]
        if math.prod(self.shape[a] for a in axes) == self.size:
            self._groups[axes] = dist.group.WORLD
            return dist.group.WORLD
        inner = [self.axis_names.index(a) for a in axes]
        outer = [i for i in range(len(self.axis_names)) if i not in inner]
        n = math.prod(self.shape[a] for a in axes)
        lines = np.transpose(self.ranks, outer + inner).reshape(-1, n)
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if get_rank() in line:
                self._groups[axes] = g
        return self._groups[axes]

    def joint_coord(self, axes) -> int:
        """This rank's index in ``joint_group(axes)``."""
        i = 0
        for a in self.axis_names:
            if a in axes:
                i = i * self.shape[a] + self._coord[a]
        return i

    def coord(self, axis: str) -> int:
        return self._coord[axis]

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def rank_at(self, **coords) -> int:
        """The world rank at `coords` (axis -> index), this rank's own
        index on every axis not named."""
        return int(self.ranks[tuple(coords.get(a, self._coord[a])
                                    for a in self.axis_names)])

    def __repr__(self):
        return f"Mesh({self.shape})"


_mesh: Mesh | None = None


def make_mesh(axes: dict[str, int] | None = None) -> Mesh:
    """A Mesh from {axis_name: size}; the sizes multiply to the world
    size, one of them may be -1 (the rest of the world). None: one "dp"
    axis over the world."""
    world = get_world_size()
    if not axes:
        return Mesh({"dp": world})
    sizes = dict(axes)
    wild = [a for a, s in sizes.items() if s == -1]
    if len(wild) > 1:
        raise ValueError(f"at most one axis may be -1, got {axes}")
    if wild:
        known = math.prod(s for s in sizes.values() if s != -1)
        sizes[wild[0]] = world // known
    return Mesh(sizes)


def default_mesh() -> Mesh:
    global _mesh
    if _mesh is None:
        _mesh = make_mesh(None)
    return _mesh


def get_mesh() -> Mesh | None:
    return _mesh


def set_mesh(mesh: Mesh | dict | None):
    global _mesh
    _mesh = make_mesh(mesh) if isinstance(mesh, dict) or mesh is None \
        else mesh
    return _mesh

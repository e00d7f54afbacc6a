"""Collective communication over ``torch.distributed`` (counterpart of
``paddle_tpu/distributed/collective.py``).

The reference has two regimes: inside a sharded trace its collectives
are ``lax.psum`` and friends over a named mesh axis; eagerly they go
across processes. The port runs one process per rank, so both are
``torch.distributed`` calls; the named axis picks the process group:
``group`` when given (a process group, or an axis name of the current
mesh), else the axis of ``collective_axis(name)`` when one is open,
else the world. Over a group of one rank (a world of one included)
every collective is the identity, as in the reference. The eager calls
work in place on the tensor they are given and return it.

The ``c_*`` ops of static programs are registered here, as the
reference registers them: inside a named axis (``axis_name``, the open
``collective_axis``, or the executor's ``mesh_axis``) they act over that
axis's group, differentiably where the reference's are (``c_allreduce_sum``,
``c_allgather``, ``c_concat``, ``c_broadcast``, ``c_reducescatter``);
outside one they are identities.

``batch_group()`` is the data-parallel group of the open axis (None
when it has one rank): the ops whose reductions run over the batch
(batch norm's statistics, the masked-LM count) reduce over it, so that
a rank's slice of a batch computes the global batch's function.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from ..fluid.ops.common import out, x
from ..fluid.registry import register, same_shape_as

__all__ = ["ReduceOp", "all_reduce", "all_gather", "broadcast", "reduce",
           "scatter", "barrier", "split", "current_axis", "collective_axis",
           "axis_group", "batch_group", "batch_total"]


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
              ReduceOp.MIN: dist.ReduceOp.MIN,
              ReduceOp.PROD: dist.ReduceOp.PRODUCT}

# the mesh axes collectives act on while a data-parallel step or program
# runs (replaces ring_id): (name, its process group, or _MESH for the
# global mesh's)
_MESH = object()
_axis_stack: list[tuple] = []


def current_axis() -> str | None:
    return _axis_stack[-1][0] if _axis_stack else None


@contextlib.contextmanager
def collective_axis(name: str, group=_MESH):
    """Collectives inside the block act over axis `name`: `group`, or
    the global mesh's group of that axis."""
    _axis_stack.append((name, group))
    try:
        yield
    finally:
        _axis_stack.pop()


def axis_group(name: str):
    """The process group of mesh axis `name` for this rank; None when
    the axis (or the world) has one rank."""
    from .mesh import default_mesh, get_mesh
    if not dist.is_initialized():
        return None
    mesh = get_mesh() or default_mesh()
    if name not in mesh.shape:
        raise ValueError(f"mesh {mesh.shape} has no axis {name!r}")
    return mesh.group(name)


def _open_group():
    """The group of the innermost open axis (None: one rank)."""
    name, group = _axis_stack[-1]
    return axis_group(name) if group is _MESH else group


def batch_group():
    """The open axis's group when it holds more than one rank, else
    None: the group a batch reduction runs over."""
    if not _axis_stack or not dist.is_initialized():
        return None
    g = _open_group()
    return g if g is not None and dist.get_world_size(g) > 1 else None


def batch_total(t):
    """(t summed over the ranks of the open axis, without gradient; the
    number of ranks): (t, 1) outside a data-parallel run."""
    g = batch_group()
    if g is None:
        return t, 1
    total = t.detach().clone()
    dist.all_reduce(total, group=g)
    return total, dist.get_world_size(g)


def _group(group):
    """(process group, its size) a collective runs over; size 1 means
    the call is the identity."""
    if not dist.is_initialized():
        return None, 1
    if isinstance(group, str):
        group = axis_group(group)
        return group, (dist.get_world_size(group) if group else 1)
    if group is None:
        group = _open_group() if _axis_stack else dist.group.WORLD
        if group is None:
            return None, 1
    return group, dist.get_world_size(group)


def _src(group, rank: int) -> int:
    """The world rank of `group`'s rank `rank` (the reference's src and
    dst are ranks of the axis)."""
    if group is None or group is dist.group.WORLD:
        return rank
    return dist.get_global_rank(group, rank)


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    g, n = _group(group)
    if n > 1:
        dist.all_reduce(tensor, _TORCH_OPS[op], group=g)
    return tensor


def all_gather(tensor_list, tensor, group=None, sync_op=True):
    g, n = _group(group)
    if n == 1:
        tensor_list.append(tensor)
        return tensor_list
    parts = [torch.empty_like(tensor) for _ in range(n)]
    dist.all_gather(parts, tensor.contiguous(), group=g)
    tensor_list.extend(parts)
    return tensor_list


def broadcast(tensor, src=0, group=None, sync_op=True):
    g, n = _group(group)
    if n > 1:
        dist.broadcast(tensor, _src(g, src), group=g)
    return tensor


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce to `dst`: only the destination's tensor takes the reduced
    value, the others keep their input (reference c_reduce_*
    semantics)."""
    g, n = _group(group)
    if n == 1:
        return tensor
    red = tensor.clone()
    dist.all_reduce(red, _TORCH_OPS[op], group=g)
    if dist.get_rank(g) == dst:
        tensor.copy_(red)
    return tensor


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Rank i of the group takes tensor_list[i] of `src` into `tensor`."""
    g, n = _group(group)
    if n == 1:
        if tensor_list:
            tensor.copy_(tensor_list[0])
        return tensor
    mine = list(tensor_list) if dist.get_rank(g) == src else None
    dist.scatter(tensor, mine, src=_src(g, src), group=g)
    return tensor


def barrier(group=None):
    g, n = _group(group)
    if n > 1:
        dist.barrier(group=g)


def split(x_, num_partitions, axis=0):
    """`x_` cut into `num_partitions` equal parts along `axis` (a list)."""
    if x_.shape[axis] % num_partitions:
        raise ValueError(f"axis {axis} of {tuple(x_.shape)} does not split "
                         f"into {num_partitions}")
    return list(torch.chunk(x_, num_partitions, dim=axis))


# ---------------------------------------------------------------------------
# c_* collective OPS for static programs (operators/collective/ parity)
# ---------------------------------------------------------------------------

def _op_group(ctx, attrs):
    """(group, size) of a c_* op: its axis_name, the open axis, or the
    executor's mesh axis; size 1 (identity) outside any."""
    if attrs.get("axis_name"):
        return _group(attrs["axis_name"])
    if _axis_stack:
        return _group(None)
    if getattr(ctx, "mesh_axis", None):
        return _group(ctx.mesh_axis)
    return None, 1


def _c_allreduce(op):
    def compute(ctx, ins, attrs):
        v = x(ins)
        g, n = _op_group(ctx, attrs)
        if n == 1:
            return out(v)
        if op == ReduceOp.SUM:
            from torch.distributed.nn import functional as dnn
            return out(dnn.all_reduce(v, group=g))
        red = v.clone()
        dist.all_reduce(red, _TORCH_OPS[op], group=g)
        return out(red)
    return compute


_ATTRS = {"ring_id": 0, "use_calc_stream": True, "axis_name": ""}
register("c_allreduce_sum", _c_allreduce(ReduceOp.SUM),
         infer_shape=same_shape_as("X"), attrs=dict(_ATTRS))
register("c_allreduce_max", _c_allreduce(ReduceOp.MAX),
         infer_shape=same_shape_as("X"), attrs=dict(_ATTRS))
register("c_allreduce_min", _c_allreduce(ReduceOp.MIN),
         infer_shape=same_shape_as("X"), attrs=dict(_ATTRS))


def _minmax_grad(ctx, ins, attrs):
    """The max/min all-reduce's gradient: over one rank the forward is
    the identity and so is this; over several it raises, as the
    reference's grad op (jax.vjp of lax.pmax / pmin, which have no
    differentiation rule) does."""
    _, n = _op_group(ctx, attrs)
    if n > 1:
        raise NotImplementedError(
            "max/min all-reduce has no gradient, as in the reference")
    return {"X@GRAD": [x(ins, "Out@GRAD")]}


def _minmax_grad_infer(op):
    v = op.invar("X")
    for name in op.output("X@GRAD"):
        if v is not None:
            op.block.create_var(name=name, shape=v.shape, dtype=v.dtype)


for _op in ("c_allreduce_max_grad", "c_allreduce_min_grad"):
    register(_op, _minmax_grad, infer_shape=_minmax_grad_infer,
             attrs=dict(_ATTRS), grad=None)


def _gathered(v, g):
    from torch.distributed.nn import functional as dnn
    return dnn.all_gather(v.contiguous(), group=g)


@register("c_allgather", attrs={"ring_id": 0, "nranks": 1,
                                "use_calc_stream": True, "axis_name": ""})
def _c_allgather(ctx, ins, attrs):
    v = x(ins)
    g, n = _op_group(ctx, attrs)
    if n == 1:
        return out(v)
    return out(torch.cat(_gathered(v, g), dim=0))


@register("c_broadcast", attrs={"ring_id": 0, "root": 0,
                                "use_calc_stream": True, "axis_name": ""})
def _c_broadcast(ctx, ins, attrs):
    v = x(ins)
    g, n = _op_group(ctx, attrs)
    if n == 1:
        return out(v)
    from torch.distributed.nn import functional as dnn
    return out(dnn.broadcast(v.contiguous(), _src(g, attrs.get("root", 0)),
                             group=g))


@register("c_reducescatter", attrs={"ring_id": 0, "nranks": 1,
                                    "use_calc_stream": True, "axis_name": ""})
def _c_reducescatter(ctx, ins, attrs):
    """The sum over the axis, this rank's tile of axis 0 (gloo has no
    reduce_scatter: all-reduce, then slice)."""
    v = x(ins)
    g, n = _op_group(ctx, attrs)
    if n == 1:
        return out(v)
    from torch.distributed.nn import functional as dnn
    red = dnn.all_reduce(v, group=g)
    return out(torch.chunk(red, n, dim=0)[dist.get_rank(g)])


@register("c_concat", attrs={"ring_id": 0, "nranks": 1, "rank": 0,
                             "axis_name": ""})
def _c_concat(ctx, ins, attrs):
    v = x(ins)
    g, n = _op_group(ctx, attrs)
    if n == 1:
        return out(v)
    return out(torch.cat(_gathered(v, g), dim=-1))


@register("c_identity", infer_shape=same_shape_as("X"),
          attrs={"ring_id": 0, "use_calc_stream": True})
def _c_identity(ctx, ins, attrs):
    return out(x(ins))


@register("c_split", attrs={"ring_id": 0, "nranks": 1, "rank": 0,
                            "axis_name": ""})
def _c_split(ctx, ins, attrs):
    v = x(ins)
    g, n = _op_group(ctx, attrs)
    if n == 1:
        return out(v)
    size = v.shape[-1] // attrs.get("nranks", n)
    i = dist.get_rank(g)
    return out(v[..., i * size:(i + 1) * size])


def _passthrough(ctx, ins, attrs):
    return out(x(ins))


def _no_outputs(ctx, ins, attrs):
    return {}  # communicator setup is the process group's


for _name in ("c_sync_calc_stream", "c_sync_comm_stream",
              "c_wait_calc_stream"):
    register(_name, _passthrough, grad=None, infer_shape=same_shape_as("X"))
register("c_comm_init_all", _no_outputs, grad=None,
         attrs={"ring_id": 0, "devices": []})
register("c_gen_nccl_id", _no_outputs, grad=None, attrs={"rank": 0})
register("c_comm_init", _no_outputs, grad=None,
         attrs={"ring_id": 0, "rank": 0, "nranks": 1})


@register("barrier", grad=None)
def _barrier_op(ctx, ins, attrs):
    g, n = _op_group(ctx, attrs)
    if n > 1:
        dist.barrier(group=g)
    return out(x(ins)) if ins.get("X") else {}

"""Graph IR: Program / Block / Operator / Variable (counterpart of
``paddle_tpu/fluid/framework.py``, the reference's ProgramDesc stack).

The Python IR is the source of truth. Ops are appended with their
attributes and shape inference runs at append time, so every op must be
registered (``registry``): appending one that the port does not have
raises ``NotImplementedError`` naming where it is queued. The Executor
runs a block op by op on the device (``executor.py``).

Dygraph mode is the default, as in the reference: eager code in the
port is torch itself, and ``enable_static()`` switches to building
Programs.
"""
from __future__ import annotations

import collections
import contextlib
import copy
from typing import Any, Iterable

import numpy as np

from . import core, unique_name

__all__ = [
    "Program", "Block", "Operator", "Variable", "Parameter",
    "default_main_program", "default_startup_program", "program_guard",
    "name_scope", "in_dygraph_mode", "grad_var_name",
    "enable_dygraph", "disable_dygraph",
]

GRAD_SUFFIX = "@GRAD"


def grad_var_name(name: str) -> str:
    return name + GRAD_SUFFIX


# ---------------------------------------------------------------------------
# dygraph-mode switch
# ---------------------------------------------------------------------------

_dygraph_mode = True


def in_dygraph_mode() -> bool:
    return _dygraph_mode


def enable_dygraph():
    global _dygraph_mode
    _dygraph_mode = True


def disable_dygraph():
    global _dygraph_mode
    _dygraph_mode = False


# ---------------------------------------------------------------------------
# name_scope
# ---------------------------------------------------------------------------

_name_scope_stack: list[str] = []


@contextlib.contextmanager
def name_scope(prefix: str):
    """Debug/profiling scopes, recorded on each op as its `name_scope`
    attribute."""
    _name_scope_stack.append(prefix)
    try:
        yield
    finally:
        _name_scope_stack.pop()


def _current_name_scope() -> str:
    return "/".join(_name_scope_stack)


# ---------------------------------------------------------------------------
# Variable
# ---------------------------------------------------------------------------

class Variable:
    """A named tensor in a Block (reference framework.py:889); `type`
    is "dense" (the LoDTensor equivalent) on every ported path."""

    def __init__(self, block: "Block", name: str, shape=None, dtype=None,
                 type: str = "dense", persistable: bool = False,
                 stop_gradient: bool = False, is_data: bool = False,
                 initializer=None, **kwargs):
        self.block = block
        self.name = name
        self.shape = tuple(int(s) for s in shape) if shape is not None else None
        self.dtype = core.convert_dtype(dtype) if dtype is not None else None
        self.type = type
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.initializer = initializer

    def __repr__(self):
        return (f"var {self.name} : shape={self.shape} dtype={self.dtype} "
                f"type={self.type} persistable={self.persistable} "
                f"stop_gradient={self.stop_gradient}")

    __str__ = __repr__

    # numpy-style protocol used by layer helpers
    def numpy(self):
        raise RuntimeError(
            "Variable.numpy() is only available on eager Tensors; run the "
            "program with an Executor to materialise static-graph variables.")


class Parameter(Variable):
    """A trainable persistable Variable (reference framework.py:5186)."""

    def __init__(self, block, name, shape, dtype, trainable=True,
                 regularizer=None, do_model_average=False, need_clip=True,
                 optimize_attr=None, **kwargs):
        super().__init__(block, name, shape=shape, dtype=dtype,
                         persistable=True, stop_gradient=not trainable,
                         **kwargs)
        self.trainable = trainable
        self.regularizer = regularizer
        self.do_model_average = do_model_average
        self.need_clip = need_clip
        self.optimize_attr = optimize_attr or {"learning_rate": 1.0}

    def __repr__(self):
        return f"param {self.name} : shape={self.shape} dtype={self.dtype}"


# ---------------------------------------------------------------------------
# Operator
# ---------------------------------------------------------------------------

class Operator:
    """One node of the graph (reference framework.py:1881 / OpDesc).

    inputs/outputs map slot name -> list of variable names. attrs are plain
    Python values; Block-valued attrs (control flow sub-blocks) are stored as
    the Block object itself and serialised as the block index.
    """

    def __init__(self, block: "Block", type: str,
                 inputs: dict | None = None, outputs: dict | None = None,
                 attrs: dict | None = None):
        from . import registry
        self.block = block
        self.type = type
        self.inputs = {k: _as_name_list(v) for k, v in (inputs or {}).items()
                       if v is not None}
        self.outputs = {k: _as_name_list(v) for k, v in (outputs or {}).items()
                        if v is not None}
        self.attrs = dict(attrs or {})
        if _current_name_scope():
            self.attrs.setdefault("name_scope", _current_name_scope())
        # an op the port does not have raises here, naming its queue
        opdef = registry.require(type)
        opdef.fill_default_attrs(self.attrs)
        if opdef.stochastic and "_rng_id" not in self.attrs:
            prog = block.program
            prog._rng_counter = getattr(prog, "_rng_counter", 0) + 1
            self.attrs["_rng_id"] = prog._rng_counter
        if opdef.infer_shape is not None:
            opdef.infer_shape(self)

    # -- slot access -------------------------------------------------------
    def input(self, slot: str) -> list[str]:
        return self.inputs.get(slot, [])

    def output(self, slot: str) -> list[str]:
        return self.outputs.get(slot, [])

    @property
    def input_arg_names(self) -> list[str]:
        return [n for ns in self.inputs.values() for n in ns]

    @property
    def output_arg_names(self) -> list[str]:
        return [n for ns in self.outputs.values() for n in ns]

    def attr(self, name: str, default=None):
        return self.attrs.get(name, default)

    def invar(self, slot: str) -> "Variable | None":
        names = self.input(slot)
        return self.block._var_recursive(names[0]) if names else None

    def __repr__(self):
        ins = ", ".join(f"{k}={v}" for k, v in sorted(self.inputs.items()))
        outs = ", ".join(f"{k}={v}" for k, v in sorted(self.outputs.items()))
        show = {k: v for k, v in self.attrs.items()
                if k != "name_scope" and
                not isinstance(v, Block)}
        return f"{{Out: {outs}}} = {self.type}(inputs={{{ins}}}, {show})"

    __str__ = __repr__


def _name_of(x) -> str:
    # Variables resolve by their .name; str(x) would embed the whole repr
    # as the "name"
    n = getattr(x, "name", None)
    return n if isinstance(n, str) else str(x)


def _as_name_list(v) -> list[str]:
    if isinstance(v, (list, tuple)):
        return [_name_of(x) for x in v]
    return [_name_of(v)]


# ---------------------------------------------------------------------------
# Block
# ---------------------------------------------------------------------------

class Block:
    """Straight-line op list + symbol table (reference framework.py:2472)."""

    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: dict[str, Variable] = collections.OrderedDict()
        self.ops: list[Operator] = []

    @property
    def parent_block(self) -> "Block | None":
        return None if self.parent_idx < 0 else self.program.block(self.parent_idx)

    # -- vars --------------------------------------------------------------
    def create_var(self, name=None, **kwargs) -> Variable:
        name = name or unique_name.generate("tmp")
        # resolve through the parent chain: a sub-block op whose output names
        # an ANCESTOR var writes through to it (reference cond/while sub-block
        # semantics) — it must NOT shadow-create a block-local copy, else the
        # write never surfaces to the parent scope
        v = self._var_recursive(name)
        if v is not None:
            # refine metadata (shape inference updates placeholder vars)
            if v.shape is None and kwargs.get("shape") is not None:
                v.shape = tuple(int(s) for s in kwargs["shape"])
            if v.dtype is None and kwargs.get("dtype") is not None:
                v.dtype = core.convert_dtype(kwargs["dtype"])
            return v
        v = Variable(self, name, **kwargs)
        self.vars[name] = v
        return v

    def create_parameter(self, name, shape, dtype, **kwargs) -> Parameter:
        # Parameters always live in the top-level block (global symbol table),
        # matching reference global-block parameter placement.
        gb = self.program.global_block()
        if name in gb.vars:
            return gb.vars[name]  # type: ignore[return-value]
        p = Parameter(gb, name, shape, dtype, **kwargs)
        gb.vars[name] = p
        return p

    def var(self, name: str) -> Variable:
        v = self.vars.get(name)
        if v is None:
            raise ValueError(f"variable {name!r} not found in block {self.idx}")
        return v

    def has_var(self, name: str) -> bool:
        return name in self.vars

    def _var_recursive(self, name: str) -> Variable | None:
        b: Block | None = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = b.parent_block
        return None

    def all_parameters(self) -> list[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    # -- ops ---------------------------------------------------------------
    def append_op(self, type: str, inputs=None, outputs=None, attrs=None,
                  stop_gradient: bool = False) -> Operator:
        if in_dygraph_mode():
            raise RuntimeError(
                f"appending op {type!r} to a Program in dygraph mode: call "
                f"paddle_tpu_torch.enable_static() first (eager code in the "
                f"port is torch itself; common_ops.run_op runs one op "
                f"eagerly)")
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        self.program._bump_version()
        return op

    def __repr__(self):
        lines = [f"block idx={self.idx} parent={self.parent_idx}"]
        lines += [f"  {v}" for v in self.vars.values()]
        lines += [f"  {op}" for op in self.ops]
        return "\n".join(lines)

    __str__ = __repr__


# ---------------------------------------------------------------------------
# Program
# ---------------------------------------------------------------------------

class Program:
    """A whole computation graph (reference framework.py:3934).

    Holds a list of Blocks; block 0 is the global block. Sub-blocks belong to
    control-flow ops (while/cond) via Block-valued attrs.
    """

    def __init__(self):
        self.blocks: list[Block] = [Block(self, 0)]
        self.current_block_idx = 0
        self.random_seed = 0
        self._is_test = False
        # set by the distributed passes (slice 5); the executor refuses it
        self._sharding_info = None
        # mutation counter → executor cache-key / analysis invalidation
        self._version = 0
        self._analysis_cache: tuple | None = None

    def _bump_version(self):
        self._version += 1
        self._analysis_cache = None
        self._prune_cache = {}  # executor's use_prune slices are stale too

    # -- block management --------------------------------------------------
    def global_block(self) -> Block:
        return self.blocks[0]

    def block(self, idx: int) -> Block:
        return self.blocks[idx]

    def current_block(self) -> Block:
        return self.blocks[self.current_block_idx]

    # -- introspection -----------------------------------------------------
    def list_vars(self) -> Iterable[Variable]:
        for b in self.blocks:
            yield from b.vars.values()

    def all_parameters(self) -> list[Parameter]:
        return self.global_block().all_parameters()

    def ops(self) -> Iterable[Operator]:
        for b in self.blocks:
            yield from b.ops

    # -- cloning -----------------------------------------------------------
    def clone(self, for_test: bool = False) -> "Program":
        """Deep copy; for_test=True flips is_test on train-sensitive ops
        (dropout/batch_norm...) like reference Program.clone (framework.py:4290)."""
        memo: dict[int, Any] = {}
        p = copy.deepcopy(self, memo)
        if for_test:
            p._is_test = True
            for op in p.ops():
                if "is_test" in op.attrs:
                    op.attrs["is_test"] = True
        return p

    def __deepcopy__(self, memo):
        p = Program.__new__(Program)
        memo[id(self)] = p
        p.random_seed = self.random_seed
        p._is_test = self._is_test
        p._version = 0
        p._analysis_cache = None
        p._sharding_info = copy.deepcopy(self._sharding_info, memo)
        p.current_block_idx = self.current_block_idx
        p.blocks = []
        for b in self.blocks:
            nb = Block(p, b.idx, b.parent_idx)
            memo[id(b)] = nb
            p.blocks.append(nb)
        for b, nb in zip(self.blocks, p.blocks):
            for name, v in b.vars.items():
                nv = copy.copy(v)
                nv.block = nb
                nb.vars[name] = nv
            for op in b.ops:
                nop = Operator.__new__(Operator)
                nop.block = nb
                nop.type = op.type
                nop.inputs = {k: list(v) for k, v in op.inputs.items()}
                nop.outputs = {k: list(v) for k, v in op.outputs.items()}
                nop.attrs = {}
                for k, v in op.attrs.items():
                    if isinstance(v, Block):
                        nop.attrs[k] = p.blocks[v.idx]
                    else:
                        nop.attrs[k] = copy.copy(v)
                nb.ops.append(nop)
        return p

    # -- structural hash for the executor's compile cache -------------------
    def _structure_key(self) -> tuple:
        items = []
        for b in self.blocks:
            for op in b.ops:
                attrs = tuple(sorted(
                    (k, v.idx if isinstance(v, Block) else _hashable(v))
                    for k, v in op.attrs.items()))
                ins = tuple(sorted((k, tuple(v)) for k, v in op.inputs.items()))
                outs = tuple(sorted((k, tuple(v)) for k, v in op.outputs.items()))
                items.append((b.idx, op.type, ins, outs, attrs))
        return tuple(items)

    def __repr__(self):
        return "\n".join(str(b) for b in self.blocks)

    __str__ = __repr__


def _hashable(v):
    if isinstance(v, (list, tuple)):
        return tuple(_hashable(x) for x in v)
    if isinstance(v, np.ndarray):
        return (v.shape, str(v.dtype), v.tobytes())
    if isinstance(v, (dict,)):
        return tuple(sorted((k, _hashable(x)) for k, x in v.items()))
    return v


# ---------------------------------------------------------------------------
# default programs & guards
# ---------------------------------------------------------------------------

_main_program_ = Program()
_startup_program_ = Program()


def default_main_program() -> Program:
    return _main_program_


def default_startup_program() -> Program:
    return _startup_program_


def switch_main_program(p: Program) -> Program:
    global _main_program_
    old, _main_program_ = _main_program_, p
    return old


def switch_startup_program(p: Program) -> Program:
    global _startup_program_
    old, _startup_program_ = _startup_program_, p
    return old


@contextlib.contextmanager
def program_guard(main_program: Program, startup_program: Program | None = None):
    old_main = switch_main_program(main_program)
    old_start = switch_startup_program(startup_program) \
        if startup_program is not None else None
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_start is not None:
            switch_startup_program(old_start)

"""CompiledProgram / strategies (counterpart of
``paddle_tpu/fluid/compiler.py``; reference python/paddle/fluid/compiler.py).

``CompiledProgram.with_data_parallel`` marks the program data-parallel
(``_sharding_info = {"mode": "dp", ...}``, as the reference marks it):
the executor then runs it on this rank's slice of every batch-sized
feed and all-reduces each parameter gradient, scaled by 1 / ranks,
before the first optimizer op (``fluid/executor.py``). The strategies'
knobs are kept for the API; the port's executor reads none of them.
"""
from __future__ import annotations

__all__ = ["CompiledProgram", "BuildStrategy", "ExecutionStrategy"]


class BuildStrategy:
    """Knob bag kept for API parity (details/build_strategy.h)."""

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    class GradientScaleStrategy:
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = \
            BuildStrategy.GradientScaleStrategy.CoeffNumDevice
        self.fuse_all_reduce_ops = True
        self.fuse_all_optimizer_ops = False
        self.fuse_elewise_add_act_ops = False
        self.enable_inplace = True
        self.memory_optimize = True
        self.sync_batch_norm = False
        self.num_trainers = 1
        self.trainer_id = 0


class ExecutionStrategy:
    def __init__(self):
        self.num_threads = 1
        self.num_iteration_per_drop_scope = 100
        self.use_experimental_executor = False


class CompiledProgram:
    def __init__(self, program_or_graph, build_strategy=None):
        self._program = program_or_graph
        self._build_strategy = build_strategy or BuildStrategy()
        self._is_data_parallel = False
        self._loss_name = None
        self._share_vars_from = None

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, share_vars_from=None,
                           places=None):
        self._is_data_parallel = True
        self._loss_name = loss_name
        if build_strategy is not None:
            self._build_strategy = build_strategy
        self._places = places
        # mark the underlying program: the executor shards the batch axis
        # of feeds over the "dp" axis and all-reduces the gradients
        self._program._sharding_info = {"mode": "dp", "loss": loss_name}
        return self

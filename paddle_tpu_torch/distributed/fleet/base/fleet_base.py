"""Fleet facade, collective and parameter-server modes (counterpart of
``paddle_tpu/distributed/fleet/base/fleet_base.py``; reference
distributed/fleet/base/fleet_base.py:125,572,937).

``init`` discovers the role and joins the process group;
``distributed_optimizer`` keeps the user's optimizer; ``minimize``
applies it (``apply_meta_optimizers``: none enabled, or the lamb and
lars flags) and marks the program data-parallel (``{"mode": "dp"}``, as the
reference's ``_sharding_info``), so the executor runs it on this rank's
slice of every batch and all-reduces the gradients;
``distributed_model`` is ``DataParallel``; ``hybrid_train_step`` builds
the dp x pp x tp GPT step from the strategy's degrees. Parameter-server
mode (``init_server`` / ``run_server`` / ``init_worker`` /
``stop_worker``) runs ``runtime/parameter_server_runtime.py``'s
``ParameterServerRuntime`` for the role maker's role. The savers raise
(ROADMAP.md A, item 12).
"""
from __future__ import annotations

from .distributed_strategy import DistributedStrategy
from .role_maker import PaddleCloudRoleMaker, RoleMakerBase

__all__ = ["Fleet", "init", "distributed_optimizer", "minimize"]


def _queued(what: str, item: str):
    raise NotImplementedError(
        f"fleet.{what} is not ported yet: it comes with ROADMAP.md A, "
        f"item {item}")


class Fleet:
    def __init__(self):
        self._role_maker: RoleMakerBase | None = None
        self._strategy: DistributedStrategy | None = None
        self._user_optimizer = None
        self._is_collective = True

    # -- lifecycle ----------------------------------------------------------
    def init(self, role_maker=None, is_collective=False, strategy=None):
        from ...env import init_parallel_env
        self._is_collective = is_collective or role_maker is None
        self._role_maker = role_maker or PaddleCloudRoleMaker(
            is_collective=True)
        self._strategy = strategy or DistributedStrategy()
        init_parallel_env()
        return self

    def is_first_worker(self):
        return self._rm().is_first_worker()

    def worker_index(self):
        return self._rm().worker_index()

    def worker_num(self):
        return self._rm().worker_num()

    def is_worker(self):
        return self._rm().is_worker()

    def worker_endpoints(self, to_string=False):
        eps = self._rm().get_trainer_endpoints()
        return ",".join(eps) if to_string else eps

    def server_num(self):
        return self._rm().server_num()

    def server_index(self):
        return self._rm().server_index()

    def server_endpoints(self, to_string=False):
        eps = self._rm().get_pserver_endpoints()
        return ",".join(eps) if to_string else eps

    def is_server(self):
        return self._rm().is_server()

    def barrier_worker(self):
        self._rm()._barrier()

    # -- parameter-server mode -----------------------------------------------
    def _runtime(self):
        if getattr(self, "_ps_runtime", None) is None:
            from ..runtime.parameter_server_runtime import \
                ParameterServerRuntime
            self._ps_runtime = ParameterServerRuntime(self._rm())
        return self._ps_runtime

    def init_worker(self):
        """Connect the worker-side PSClient to all server endpoints."""
        return self._runtime().init_worker()

    def init_server(self, *args, **kwargs):
        self._runtime().init_server(*args, **kwargs)

    def run_server(self, block: bool = True):
        """Serve this shard. Blocks like the reference's run_server unless
        block=False (in-process tests)."""
        return self._runtime().run_server(block=block)

    def stop_worker(self):
        self._runtime().stop_worker()

    # -- savers ---------------------------------------------------------------
    def save_inference_model(self, *args, **kwargs):
        _queued("save_inference_model (fluid.io)", "12")

    def save_persistables(self, *args, **kwargs):
        _queued("save_persistables (fluid.io)", "12")

    # -- optimization --------------------------------------------------------
    def distributed_optimizer(self, optimizer, strategy=None):
        self._user_optimizer = optimizer
        if strategy is not None:
            self._strategy = strategy
        return self

    def distributed_model(self, model):
        from ...parallel import DataParallel
        return DataParallel(model)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from ..meta_optimizers import apply_meta_optimizers
        opt = apply_meta_optimizers(self._user_optimizer, self._strategy,
                                    self._rm())
        res = opt.minimize(loss, startup_program, parameter_list, no_grad_set)
        loss.block.program._sharding_info = _sharding_info_from_strategy(
            self._strategy or DistributedStrategy(), loss)
        return res

    @property
    def user_defined_optimizer(self):
        return self._user_optimizer

    def _rm(self) -> RoleMakerBase:
        if self._role_maker is None:
            self.init()
        return self._role_maker

    # dygraph helpers
    def get_loss_scaling(self):
        return None

    def hybrid_train_step(self, cfg, **kwargs):
        """The hybrid GPT train step from this fleet's strategy
        (``hybrid_configs`` and the pipeline / tensor-parallel /
        sequence-parallel / expert-parallel / ZeRO ``sharding`` flags),
        over a world of dp * pp * sp * ep * tp ranks."""
        from ....parallel.hybrid import HybridParallelTrainStep
        st = self._strategy or DistributedStrategy()
        hc = st.hybrid_configs
        dp, pp, tp = hc["dp_degree"], hc["pp_degree"], hc["mp_degree"]
        if st.tensor_parallel and tp == 1:
            tp = st.tensor_parallel_configs["tensor_parallel_degree"]
        sp = hc.get("sp_degree", 1)
        if st.sequence_parallel and sp == 1:
            sp = st.sequence_parallel_configs["sp_degree"]
        kwargs.setdefault("sp", sp)
        micro = hc["micro_batches"]
        if st.pipeline and micro is None:
            acc = st.pipeline_configs.get("accumulate_steps") or 0
            micro = acc if acc > 1 else None
        kwargs.setdefault("n_microbatches", micro)
        kwargs.setdefault("pipeline_schedule",
                          st.pipeline_configs.get("schedule_mode", "1F1B"))
        ep = hc.get("ep_degree", 1)
        if st.expert_parallel and ep == 1:
            ep = st.expert_parallel_configs["ep_degree"]
        kwargs.setdefault("ep", ep)
        kwargs.setdefault("sharding", bool(st.sharding))  # ZeRO-1
        return HybridParallelTrainStep(cfg, dp=dp, pp=pp, tp=tp, **kwargs)


def _sharding_info_from_strategy(strategy: DistributedStrategy,
                                 loss=None) -> dict:
    """The reference's program marking; the port also records the loss,
    whose fetched value the executor averages over the ranks."""
    info = {"mode": "dp"}
    if loss is not None:
        info["loss"] = loss.name
    if strategy.tensor_parallel:
        info["tp"] = strategy.tensor_parallel_configs[
            "tensor_parallel_degree"]
        info["tp_rules"] = list(
            strategy.tensor_parallel_configs.get("sharding_rules") or [])
    if strategy.pipeline:
        info["pp"] = strategy.pipeline_configs
    if strategy.sequence_parallel:
        info["sp"] = strategy.sequence_parallel_configs["sp_degree"]
    return info


_fleet = Fleet()


def init(role_maker=None, is_collective=False, strategy=None):
    return _fleet.init(role_maker, is_collective, strategy)


def distributed_optimizer(optimizer, strategy=None):
    return _fleet.distributed_optimizer(optimizer, strategy)


def minimize(loss, **kw):
    return _fleet.minimize(loss, **kw)


is_first_worker = _fleet.is_first_worker
worker_index = _fleet.worker_index
worker_num = _fleet.worker_num
is_worker = _fleet.is_worker
worker_endpoints = _fleet.worker_endpoints
server_num = _fleet.server_num
server_index = _fleet.server_index
server_endpoints = _fleet.server_endpoints
is_server = _fleet.is_server
barrier_worker = _fleet.barrier_worker
init_worker = _fleet.init_worker
init_server = _fleet.init_server
run_server = _fleet.run_server
stop_worker = _fleet.stop_worker
distributed_model = _fleet.distributed_model
hybrid_train_step = _fleet.hybrid_train_step

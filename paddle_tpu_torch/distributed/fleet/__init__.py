"""paddle_tpu_torch.distributed.fleet — the fleet 2.0 facade in collective
mode (``init``, the worker queries, ``distributed_optimizer``,
``distributed_model``, ``minimize``, ``hybrid_train_step``), the
``DistributedStrategy`` bag and the role makers; parameter-server mode
(``init_server``, ``run_server``, ``init_worker``, ``stop_worker``) over
``runtime``'s PS shards and clients, the ``FleetWrapper`` /
``DownpourWorker`` pair, ``BoxPSWrapper``'s hot-row cache and the heter
workers (``HeterCpuWorker``, ``HeterDenseWorker``); ``ps_roles`` holds
the shard and worker processes. Names load on first use, so that
``runtime.rpc`` and the PS shards import without torch.
"""
__all__ = ["DistributedStrategy", "init", "is_first_worker", "worker_index",
           "worker_num", "is_worker", "worker_endpoints", "server_num",
           "server_index", "server_endpoints", "is_server", "barrier_worker",
           "init_worker", "init_server", "run_server", "stop_worker",
           "distributed_optimizer", "distributed_model", "minimize",
           "hybrid_train_step", "PaddleCloudRoleMaker",
           "UserDefinedRoleMaker", "Role", "Fleet", "FleetWrapper",
           "DownpourWorker", "BoxPSWrapper", "HeterCpuWorker",
           "HeterDenseWorker"]

_BASE = ("DistributedStrategy", "PaddleCloudRoleMaker",
         "UserDefinedRoleMaker", "Role")


def __getattr__(name):
    if name in ("DistributedStrategy",):
        from .base import distributed_strategy as home
    elif name in _BASE:
        from .base import role_maker as home
    elif name in ("FleetWrapper", "DownpourWorker"):
        from . import fleet_wrapper as home
    elif name == "BoxPSWrapper":
        from . import boxps_cache as home
    elif name in ("HeterCpuWorker", "HeterDenseWorker"):
        from . import heter_worker as home
    elif name in __all__:
        from .base import fleet_base as home
    else:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    value = getattr(home, name)
    globals()[name] = value
    return value

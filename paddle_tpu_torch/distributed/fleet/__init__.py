"""paddle_tpu_torch.distributed.fleet — the fleet 2.0 facade in collective
mode (``init``, the worker queries, ``distributed_optimizer``,
``distributed_model``, ``minimize``, ``hybrid_train_step``), the
``DistributedStrategy`` bag and the role makers, beside ``runtime``'s
fault injector and wire. The facade loads on first use, so that
``runtime.rpc`` imports without torch. Parameter-server mode, the
fleet wrapper, heter workers and BoxPS wait for ROADMAP.md A, item 16.
"""
__all__ = ["DistributedStrategy", "init", "is_first_worker", "worker_index",
           "worker_num", "is_worker", "worker_endpoints", "server_num",
           "server_index", "server_endpoints", "is_server", "barrier_worker",
           "init_worker", "init_server", "run_server", "stop_worker",
           "distributed_optimizer", "distributed_model", "minimize",
           "hybrid_train_step", "PaddleCloudRoleMaker",
           "UserDefinedRoleMaker", "Role", "Fleet"]

_BASE = ("DistributedStrategy", "PaddleCloudRoleMaker",
         "UserDefinedRoleMaker", "Role")


def __getattr__(name):
    if name in ("DistributedStrategy",):
        from .base import distributed_strategy as home
    elif name in _BASE:
        from .base import role_maker as home
    elif name in __all__:
        from .base import fleet_base as home
    else:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    value = getattr(home, name)
    globals()[name] = value
    return value

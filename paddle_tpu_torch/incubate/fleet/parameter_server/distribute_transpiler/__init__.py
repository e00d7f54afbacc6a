"""fleet 1.x transpiler-mode PS API (counterpart of
``paddle_tpu/incubate/fleet/parameter_server/distribute_transpiler``;
reference python/paddle/fluid/incubate/fleet/parameter_server/
distribute_transpiler/__init__.py):

    fleet.init(role_maker)
    opt = fleet.distributed_optimizer(optimizer, strategy)
    opt.minimize(loss)
    if fleet.is_server():
        fleet.init_server(); fleet.run_server()
    else:
        fleet.init_worker(); exe.run(fleet.main_program); fleet.stop_worker()

The role queries and the server side (a PSServer shard over TCP) run;
``minimize`` transpiles the program with ``fluid.transpiler``'s
DistributeTranspiler and ``save_persistables`` goes through
``fluid.io``, both of which raise naming ROADMAP.md A, item 12.
StrategyFactory mirrors the reference's sync/async/geo split."""
from __future__ import annotations

__all__ = ["fleet", "DistributedTranspiler", "TranspilerOptimizer",
           "StrategyFactory"]


def _config():
    from .....fluid.transpiler import DistributeTranspilerConfig
    return DistributeTranspilerConfig()


class StrategyFactory:
    @staticmethod
    def create_async_strategy():
        cfg = _config()
        cfg.sync_mode = False
        return cfg

    @staticmethod
    def create_sync_strategy():
        cfg = _config()
        cfg.sync_mode = True
        return cfg

    @staticmethod
    def create_geo_strategy(update_frequency=100):
        cfg = _config()
        cfg.sync_mode = False
        cfg.geo_sgd_need_push_nums = update_frequency
        return cfg


class _Fleet:
    def __init__(self):
        self._role_maker = None
        self._transpiler = None
        self._main_program = None
        self._server = None

    # -- lifecycle ------------------------------------------------------
    def init(self, role_maker=None):
        from ...base.role_maker import PaddleCloudRoleMaker
        self._role_maker = role_maker or PaddleCloudRoleMaker()
        self._role_maker._generate_role()
        return self

    def is_worker(self):
        return self._role_maker.is_worker()

    def is_server(self):
        return self._role_maker.is_server()

    def is_first_worker(self):
        return self._role_maker.is_first_worker()

    def worker_index(self):
        return self._role_maker.worker_index()

    def worker_num(self):
        return self._role_maker.worker_num()

    def server_num(self):
        return self._role_maker.server_num()

    # -- optimizer ------------------------------------------------------
    def distributed_optimizer(self, optimizer, strategy=None):
        return TranspilerOptimizer(self, optimizer, strategy)

    # -- programs -------------------------------------------------------
    @property
    def main_program(self):
        return self._main_program

    # -- server side ----------------------------------------------------
    def init_server(self, model_dir=None):
        pass  # tables init lazily (large_scale_kv init rules)

    def run_server(self):
        """Serve this role's shard until ``stop_server`` (blocks)."""
        from .....distributed.fleet.runtime. \
            parameter_server_runtime import PSServer
        eps = self._role_maker.get_pserver_endpoints()
        idx = self._role_maker.server_index()
        self._server = PSServer(eps[idx])
        t = self._server.serve_in_thread()
        t.join()

    def stop_server(self):
        if self._server is not None:
            self._server.shutdown()

    # -- worker side ----------------------------------------------------
    def init_worker(self):
        pass

    def stop_worker(self):
        pass

    def save_persistables(self, executor, dirname, main_program=None):
        raise NotImplementedError(
            "fleet.save_persistables (fluid.io) is not ported yet: it "
            "comes with ROADMAP.md A, item 12")


class TranspilerOptimizer:
    """Wraps the user optimizer; minimize() builds the local graph then
    transpiles it for this role (reference TranspilerOptimizer)."""

    def __init__(self, fleet_, inner, strategy=None):
        from .....fluid.transpiler import DistributeTranspilerConfig
        self._fleet = fleet_
        self._inner = inner
        if strategy is not None and not isinstance(
                strategy, DistributeTranspilerConfig):
            raise TypeError(
                "strategy must come from StrategyFactory / "
                "DistributeTranspilerConfig")
        self._strategy = strategy or StrategyFactory \
            .create_async_strategy()

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from .....fluid.transpiler import DistributeTranspiler
        t = DistributeTranspiler(self._strategy)
        res = self._inner.minimize(loss, startup_program,
                                   parameter_list, no_grad_set)
        rm = self._fleet._role_maker
        t.transpile(
            trainer_id=rm.worker_index(),
            program=loss.block.program,
            pservers=",".join(rm.get_pserver_endpoints()),
            trainers=rm.worker_num())
        self._fleet._transpiler = t
        if rm.is_worker():
            self._fleet._main_program = t.get_trainer_program()
        return res


fleet = _Fleet()
DistributedTranspiler = _Fleet  # reference alias

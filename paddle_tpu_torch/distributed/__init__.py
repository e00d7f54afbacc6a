"""paddle_tpu_torch.distributed — data parallelism over
``torch.distributed`` (counterpart of ``paddle_tpu.distributed``):

  env.py         — rank / world bootstrap from the PADDLE_* env, backend
  mesh.py        — named axes over the ranks, a process group an axis
  collective.py  — all_reduce / all_gather / ... and the c_* ops
  parallel.py    — DataParallel and the bucketed gradient all-reduce
  spawn.py       — worker processes with the launcher's env
  recompute.py   — activation recompute
  fleet/         — the fleet facade's collective and parameter-server
                   modes, the strategy bag, the PS runtime, workers and
                   cache, and the runtime's fault injector and wire
  fs.py          — LocalFS / HDFSClient, the PS snapshots' storage

The names below load on first use, so that ``fleet.runtime.rpc`` (the
serving and PS wire) still imports without torch. The hybrid step (dp x pp x
tp x sp x ep), ring attention, the expert layer and the row-sharded
embedding are ``paddle_tpu_torch.parallel``.
"""
import importlib

__all__ = ["get_rank", "get_world_size", "init_parallel_env", "ParallelEnv",
           "all_reduce", "all_gather", "broadcast", "reduce", "scatter",
           "barrier", "split", "ReduceOp", "fleet", "DataParallel", "spawn",
           "get_mesh", "set_mesh", "default_mesh"]

_ENV = ("get_rank", "get_world_size", "init_parallel_env", "ParallelEnv")
_MESH = ("get_mesh", "set_mesh", "default_mesh", "make_mesh")
_COLLECTIVE = ("all_reduce", "all_gather", "broadcast", "reduce", "scatter",
               "barrier", "split", "ReduceOp")


def __getattr__(name):
    if name == "fleet":
        return importlib.import_module(".fleet", __name__)
    if name in _ENV:
        from . import env as home
    elif name in _MESH:
        from . import mesh as home
    elif name in _COLLECTIVE:
        from . import collective as home
    elif name == "DataParallel":
        from . import parallel as home
    elif name == "spawn":
        # not `from . import spawn`: that would ask this hook for "spawn"
        # before the submodule is loaded (so for "fleet" above)
        home = importlib.import_module(".spawn", __name__)
    else:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    value = getattr(home, name)
    # bound here, over the submodule of the same name (spawn)
    globals()[name] = value
    return value

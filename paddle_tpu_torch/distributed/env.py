"""Process/world bootstrap over ``torch.distributed`` (counterpart of
``paddle_tpu/distributed/env.py``).

The reference starts ``jax.distributed`` from the launcher's PADDLE_*
environment; the port starts a process group from the same variables:
``PADDLE_TRAINER_ID`` (rank), ``PADDLE_TRAINERS_NUM`` (world size) and
``PADDLE_COORDINATOR`` (``host:port`` of the rendezvous, rank 0's
endpoint under the launcher and ``spawn``). A world of one needs no
init, as in the reference.

Backend: ``nccl`` when every rank of this host has a card of its own,
``gloo`` on the CPU and when ranks share a card (NCCL refuses two ranks
on one GPU; gloo all-reduces and broadcasts CUDA tensors through the
host). The ranks of this host are the trainer endpoints on this rank's
host (``PADDLE_TRAINER_ENDPOINTS``, ``PADDLE_CURRENT_ENDPOINT``); a
rank's card is ``cuda:(local_rank % device_count)``.
"""
from __future__ import annotations

import datetime
import os
import sys

import torch
import torch.distributed as dist

__all__ = ["init_parallel_env", "get_rank", "get_world_size", "ParallelEnv",
           "backend_for", "rank_device"]

_DEFAULT_ENDPOINT = "127.0.0.1:6170"
# rendezvous and collective deadline: a rank that never arrives fails
# the others instead of hanging them
_TIMEOUT = datetime.timedelta(seconds=120)


def _endpoints() -> list[str]:
    eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
    return eps.split(",") if eps else [_DEFAULT_ENDPOINT]


def _local() -> tuple[int, int]:
    """(this rank's index among the ranks of its host, their number)."""
    eps = _endpoints()
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    cur = os.environ.get("PADDLE_CURRENT_ENDPOINT",
                         eps[rank] if rank < len(eps) else eps[0])
    host = cur.rsplit(":", 1)[0]
    mine = [e for e in eps if e.rsplit(":", 1)[0] == host]
    return (mine.index(cur) if cur in mine else 0), max(len(mine), 1)


def backend_for(local_world: int, device_count: int) -> str:
    """``nccl`` when each of this host's ranks has a card of its own,
    else ``gloo``."""
    return "nccl" if 0 < local_world <= device_count else "gloo"


def rank_device(local_rank: int) -> torch.device:
    """This rank's card, or the CPU on a host without one."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return torch.device("cuda", local_rank % n) if n else torch.device("cpu")


def init_parallel_env():
    """Join the process group named by the PADDLE_* environment (once);
    returns ``ParallelEnv()``. With one trainer, or without a
    coordinator, nothing is started."""
    if dist.is_initialized():
        return ParallelEnv()
    coord = os.environ.get("PADDLE_COORDINATOR")
    nproc = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    if coord and nproc > 1:
        local_rank, local_world = _local()
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        backend = backend_for(local_world, n_cards)
        device = rank_device(local_rank)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        print(f"paddle_tpu_torch.distributed: rank {rank} of {nproc}, "
              f"backend {backend}, device {device}", file=sys.stderr,
              flush=True)
        dist.init_process_group(backend, init_method=f"tcp://{coord}",
                                world_size=nproc, rank=rank,
                                timeout=_TIMEOUT)
    return ParallelEnv()


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


class ParallelEnv:
    """The reference's ``fluid/dygraph/parallel.py`` ParallelEnv."""

    @property
    def rank(self) -> int:
        return get_rank()

    @property
    def world_size(self) -> int:
        return get_world_size()

    @property
    def nranks(self) -> int:
        return get_world_size()

    @property
    def local_rank(self) -> int:
        return _local()[0]

    @property
    def dev_id(self) -> int:
        n = self.device_count
        return self.local_rank % n if n else 0

    @property
    def device_count(self) -> int:
        return torch.cuda.device_count() if torch.cuda.is_available() else 0

    @property
    def backend(self) -> str | None:
        return dist.get_backend() if dist.is_initialized() else None

    @property
    def current_endpoint(self) -> str:
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", _DEFAULT_ENDPOINT)

    @property
    def trainer_endpoints(self) -> list[str]:
        return _endpoints()

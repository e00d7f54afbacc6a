"""``paddle.distributed.spawn`` (counterpart of
``paddle_tpu/distributed/spawn.py``).

Starts `nprocs` worker processes with the launcher's PADDLE_* env and
runs ``func(*args)`` in each. The start method is ``spawn``: CUDA does
not survive a fork. A worker that fails, or a run past `timeout`
seconds, terminates the others and raises. A worker's env is the
launcher's (``distributed/launch.py``'s ``get_cluster_env``, importable
from here under that name too); for elastic jobs (restarts, heartbeats,
cluster checkpoints) start the script under
``python -m paddle_tpu_torch.distributed.launch`` instead.
"""
from __future__ import annotations

import atexit
import multiprocessing as mp
import os
import socket
import sys
import time

from .launch import get_cluster_env

__all__ = ["spawn", "get_cluster_env"]


def _worker(rank, endpoints, func, args):
    os.environ.update(get_cluster_env(rank, endpoints))
    func(*args)
    _leave()


def _leave():
    """Tear the process group down, then leave without the runtime's own
    teardown (the atexit hooks still run): under load a thread left
    joinable is destroyed there and the process aborts ("terminate
    called without an active exception", exit -6) after its work is
    done and its group is gone. A launcher's child that joined a group
    leaves the same way (else the launcher reads the abort as a
    crash)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    atexit._run_exitfuncs()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def _free_ports(n: int) -> list[int]:
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def spawn(func, args=(), nprocs=-1, join=True, daemon=False,
          started_port=None, timeout=None, **options):
    """Run func in `nprocs` processes (nprocs <= 1: run inline).

    Ports default to freshly bound free ports (a fixed base would collide
    across concurrent spawns on one host); rank 0's is the rendezvous.
    With join=False the processes are returned unjoined."""
    if nprocs is None or nprocs <= 1:
        func(*args)
        return None
    if started_port is None:
        ports = _free_ports(nprocs)
    else:
        ports = [started_port + i for i in range(nprocs)]
    endpoints = [f"127.0.0.1:{p}" for p in ports]
    ctx = mp.get_context("spawn")
    procs = []
    for rank in range(nprocs):
        p = ctx.Process(target=_worker,
                        args=(rank, endpoints, func, args), daemon=daemon)
        p.start()
        procs.append(p)
    if not join:
        return procs
    deadline = None if timeout is None else time.monotonic() + timeout
    failed = []
    while True:
        codes = [p.exitcode for p in procs]
        failed = [(r, c) for r, c in enumerate(codes)
                  if c is not None and c != 0]
        if failed or all(c == 0 for c in codes):
            break
        if deadline is not None and time.monotonic() > deadline:
            failed = [(r, "timeout") for r, c in enumerate(codes)
                      if c is None]
            break
        time.sleep(0.05)
    if failed:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join(5)
        raise RuntimeError(f"spawn workers failed: {failed}")
    for p in procs:
        p.join()
    return None

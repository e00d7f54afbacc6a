"""Helpers of the port's parameter-server tests: ports, polling, and the shared
helpers of ``paddle_tpu_torch.distributed.fleet.ps_roles`` (its role
processes, each with a timeout and killed in a ``finally`` by the
caller; seeded batches; the tables a wide&deep run leaves behind)."""
from __future__ import annotations

import socket
import time

import numpy as np

from paddle_tpu_torch.distributed.fleet.ps_roles import (  # noqa: F401
    REPO, ctr_batches, role_env, run_tables, spawn, spawn_shard, stop)


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def endpoint() -> str:
    return f"127.0.0.1:{free_port()}"


def assert_tables_close(got: dict, want: dict, rtol=1e-4, atol=1e-6):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def wait_for(cond, timeout=15.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")

"""Process roles of a parameter-server job (the port's counterpart of
``scripts/widedeep_ps_bench.py`` and of the JAX package's test
fixtures): one process per role, configured by the environment.

    python -m paddle_tpu_torch.distributed.fleet.ps_roles

ROLE=server     a PSServer shard on MY_ENDPOINT until killed. The
                snapshot tier and fault injection read their own
                PADDLE_PS_* knobs. Prints one ready line, JSON:
                {"endpoint", "restored", "native", "pid"} ("native": the
                shard's tables run on the C++ core).
ROLE=worker     a DownpourWorker over PS_ENDPOINTS (TCP), WideDeepConfig()
                (CONFIG=tiny: the tiny one), batch BATCH of Zipf(1.3) ids
                from RandomState(7 + WORKER_ID), lr 0.05, WARMUP + STEPS
                steps; MODE=boxps wraps the FleetWrapper in the BoxPS
                cache (capacity 1 << 21, flush every FLUSH_EVERY). Worker
                0 seeds the dense tables. DEVICE (default: cuda) is the
                card the local step runs on. After the warm-up, one step
                runs under torch.profiler (the card's busy ms in a step)
                and the WORKERS workers meet at a fetch barrier, so their
                timed windows start together. Prints one JSON line: ex/s,
                the window's start and end (time.time()), wire MB,
                median pull / local-step / push / step ms, the device's
                busy share of a step, peak memory, losses.
ROLE=trainer    the fleet 1.x PS lifecycle on the tiny config:
                ``incubate`` fleet.init with a worker role maker of
                WORKERS workers, then DownpourWorker (lr 0.1, DEVICE)
                on ROUNDS batches of ``ctr_batches`` from seed
                100 + WORKER_ID. Prints "LOSS <head> <tail>" (the means
                of the first and last ten losses).
ROLE=heter_cpu  a HeterCpuWorker over PS_ENDPOINTS and DENSE_ENDPOINT,
                the worker recipe's batches and its fetch barrier among
                WORKERS; prints one JSON line.

A shard imports neither torch nor anything of the card. The helpers
below (spawn a role, read a shard's ready line, stop processes, the
learnable CTR batches, read a run's tables back) serve ``chip_smoke.py``
and the port's tests.
"""
from __future__ import annotations

import json
import os
import select
import statistics
import subprocess
import sys
import time

import numpy as np

# the checkout's root: role processes run from it, with it on PYTHONPATH
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))


def role_env(**kw) -> dict:
    """This process's environment with the checkout on PYTHONPATH and
    `kw` (stringified) on top."""
    env = dict(os.environ)
    path = env.get("PYTHONPATH")
    env["PYTHONPATH"] = REPO + (os.pathsep + path if path else "")
    env.update({k: str(v) for k, v in kw.items()})
    return env


def spawn(**kw) -> subprocess.Popen:
    """One role process; `kw` is its environment (ROLE=...). The caller
    gives it a timeout and stops it in a ``finally``."""
    return subprocess.Popen([sys.executable, "-m", __spec__.name],
                            env=role_env(**kw), cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def ready(p: subprocess.Popen, timeout: float = 60.0) -> dict:
    """A shard's ready line, within `timeout` seconds."""
    if not select.select([p.stdout], [], [], timeout)[0]:
        p.kill()
        raise TimeoutError(f"PS shard gave no ready line in {timeout} s")
    line = p.stdout.readline()
    if not line:
        p.kill()
        raise RuntimeError("PS shard exited before its ready line: "
                           f"{p.stderr.read()[-2000:]}")
    return json.loads(line)


def spawn_shard(ep: str, timeout: float = 60.0, **kw):
    """A shard on `ep` and its ready line."""
    p = spawn(ROLE="server", MY_ENDPOINT=ep, **kw)
    return p, ready(p, timeout)


def stop(procs):
    """Kill what still runs and reap everything."""
    for p in procs:
        if p.poll() is None:
            p.kill()
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            pass


def ctr_batches(cfg, n: int, batch: int = 64, seed: int = 0) -> list:
    """The JAX package's learnable CTR batches (tests/test_fleet_wrapper.py):
    hot ids in disjoint per-slot ranges of 32, labels from slot 0's
    parity and the first dense feature."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rng.randint(0, 32, (batch, cfg.num_slots)) + \
            np.arange(cfg.num_slots) * 32
        dense = rng.randn(batch, cfg.dense_dim).astype(np.float32)
        logit = (ids[:, 0] % 2) * 2.0 - 1.0 + dense[:, 0]
        out.append((ids, dense, (logit > 0).astype(np.float32)[:, None]))
    return out


def run_tables(fw, worker, cfg) -> dict:
    """Every table of a wide&deep run over ``ctr_batches``' ids, pulled
    back through `fw`."""
    ids = np.arange(cfg.num_slots * 32, dtype=np.int64)
    out = {"embed": fw.pull_sparse("embed", ids, cfg.embed_dim).copy(),
           "wide": fw.pull_sparse("wide", ids, 1).copy(),
           "wide_dense": fw.pull_dense(
               "wide_dense", worker._ref["wide_dense"].shape).copy(),
           "bias": fw.pull_dense("bias", worker._ref["bias"].shape).copy()}
    for i, layer in enumerate(worker._ref["mlp"]):
        for k in ("w", "b"):
            out[f"mlp{i}.{k}"] = fw.pull_dense(f"mlp{i}.{k}",
                                               layer[k].shape).copy()
    return out


def _env(name: str, default: str) -> str:
    return os.environ.get(name, default)


def _config():
    from ...models.wide_deep import WideDeepConfig
    return WideDeepConfig.tiny() if _env("CONFIG", "") == "tiny" \
        else WideDeepConfig()


def _device():
    """The worker's card, set explicitly: every process on the host has
    its own context on it."""
    import torch
    dev = torch.device(_env("DEVICE", "cuda"))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("ps_roles: DEVICE is cuda and no card is "
                               "available")
        torch.cuda.set_device(dev.index or 0)
    return dev


def zipf_batches(cfg, batch: int, wid: int):
    """The JAX package's bench batches: Zipfian ids (CTR id traffic is
    heavy-tailed, which is what makes a hot-row cache meaningful),
    Gaussian dense features, labels from slot 0's parity."""
    rng = np.random.RandomState(7 + wid)
    while True:
        ids = (rng.zipf(1.3, (batch, cfg.num_slots)) - 1) % cfg.vocab_size
        dense = rng.randn(batch, cfg.dense_dim).astype(np.float32)
        label = (ids[:, 0] % 2).astype(np.float32)[:, None]
        yield ids, dense, label


def serve():
    from .runtime.parameter_server_runtime import LargeScaleKV, PSServer
    server = PSServer(os.environ["MY_ENDPOINT"])
    print(json.dumps({"endpoint": server.endpoint,
                      "restored": bool(server.snapshot_dir
                                       and server.tables),
                      "native": LargeScaleKV(1)._native is not None,
                      "pid": os.getpid()}), flush=True)
    server.serve_forever()


def busy_ms(torch, step) -> float | None:
    """The card's busy ms in one call of step(): the device time of the
    kernels and copies this process launched in it (torch.profiler over
    CUPTI; a second process's work on the card is not in it). One call
    runs first under the profiler's warm-up and is dropped. None when
    the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from ...observability import TRACER
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        step()
        torch.cuda.synchronize()
        prof.step()
        step()
        torch.cuda.synchronize()
    spans = {sp.name for sp in TRACER.spans()}
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and e.name not in spans
             and not getattr(e, "is_user_annotation", False))
    return us / 1e3 if us else None


def _window(barrier, wid: int, steps: int, step) -> tuple[float, float]:
    """Meet the other workers at `barrier`, then run `steps` steps: the
    window's (start, end) on time.time(), which every process on the
    host shares, so a caller can merge the workers' windows."""
    workers = int(_env("WORKERS", "1"))
    if workers > 1:
        barrier(wid, workers)
    t0 = time.time()
    for _ in range(steps):
        step()
    return t0, time.time()


def work():
    import torch

    from ...ops import launch_counts
    from .fleet_wrapper import DownpourWorker, FleetWrapper
    dev = _device()
    wid = int(_env("WORKER_ID", "0"))
    steps = int(_env("STEPS", "8"))
    warmup = int(_env("WARMUP", "1"))
    batch = int(_env("BATCH", "4096"))
    cfg = _config()
    fw = FleetWrapper(endpoints=os.environ["PS_ENDPOINTS"].split(","))
    kv = fw
    if _env("MODE", "") == "boxps":
        from .boxps_cache import BoxPSWrapper
        kv = BoxPSWrapper(fw, capacity=1 << 21,
                          flush_every=int(_env("FLUSH_EVERY", "8")))
    worker = DownpourWorker(kv, cfg, lr=0.05, device=dev)
    if wid == 0:
        worker.push_initial_dense()
    else:
        time.sleep(1.0)   # let worker 0 seed the dense tables
    data = zipf_batches(cfg, batch, wid)

    def step():
        worker.train_one_batch(*next(data))

    for _ in range(warmup):
        step()
    busy = busy_ms(torch, step) if dev.type == "cuda" else None
    cl = fw._client
    b_out0, b_in0 = cl.bytes_out, cl.bytes_in
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    first = len(worker.timings)
    t0, t1 = _window(cl.fetch_barrier, wid, steps, step)
    tm = worker.timings[first:]

    def med_ms(key):
        return statistics.median(t[key] for t in tm) * 1e3

    out = {"worker": wid, "device": str(dev),
           "examples_per_sec": batch * steps / (t1 - t0),
           "window": [t0, t1],
           "push_pull_mb_out": (cl.bytes_out - b_out0) / 1e6,
           "push_pull_mb_in": (cl.bytes_in - b_in0) / 1e6,
           "steps": steps, "batch": batch,
           "pull_ms": med_ms("pull_s"), "local_ms": med_ms("local_s"),
           "push_ms": med_ms("push_s"), "step_ms": med_ms("step_s"),
           "busy_ms": busy,
           "busy_share": None if busy is None
           else busy / med_ms("step_s"),
           "losses": worker._losses,
           "port_launches": launch_counts()}
    if dev.type == "cuda":
        out["max_memory_allocated_gb"] = \
            torch.cuda.max_memory_allocated() / 1e9
    if kv is not fw:
        out["cache_hits"] = kv.cache_hits
        out["cache_misses"] = kv.cache_misses
    fw.stop()
    print(json.dumps(out), flush=True)


def train():
    from ...incubate.fleet.base.role_maker import Role, UserDefinedRoleMaker
    from ...incubate.fleet.parameter_server.distribute_transpiler import \
        fleet
    from .fleet_wrapper import DownpourWorker, FleetWrapper
    dev = _device()
    wid = int(_env("WORKER_ID", "0"))
    rm = UserDefinedRoleMaker(
        current_id=wid, role=Role.WORKER,
        worker_num=int(_env("WORKERS", "2")),
        server_endpoints=os.environ["PS_ENDPOINTS"].split(","))
    fleet.init(rm)
    assert fleet.is_worker()
    cfg = _config()
    fw = FleetWrapper.from_role_maker(rm)
    worker = DownpourWorker(fw, cfg, lr=0.1, device=dev)
    if wid == 0:
        worker.push_initial_dense()
    else:
        time.sleep(1.5)   # let worker 0 seed the dense tables
    losses = [worker.train_one_batch(*b) for b in ctr_batches(
        cfg, int(_env("ROUNDS", "130")), seed=100 + wid)]
    fw.stop()
    print("LOSS", np.mean(losses[:10]), np.mean(losses[-10:]), flush=True)


def heter_cpu():
    from .heter_worker import HeterCpuWorker
    wid = int(_env("WORKER_ID", "0"))
    steps = int(_env("STEPS", "8"))
    warmup = int(_env("WARMUP", "1"))
    batch = int(_env("BATCH", "4096"))
    cfg = _config()
    w = HeterCpuWorker(cfg, os.environ["DENSE_ENDPOINT"],
                       ps_endpoints=os.environ["PS_ENDPOINTS"].split(","),
                       lr=0.05)
    data = zipf_batches(cfg, batch, wid)

    def step():
        w.train_one_batch(*next(data))

    for _ in range(warmup):
        step()
    t0, t1 = _window(w._kv.fetch_barrier, wid, steps, step)
    print(json.dumps({"worker": wid, "examples_per_sec": batch * steps
                      / (t1 - t0), "window": [t0, t1], "steps": steps,
                      "batch": batch,
                      "losses": [float(v) for v in w.losses]}), flush=True)
    w.close()


ROLES = {"server": serve, "worker": work, "trainer": train,
         "heter_cpu": heter_cpu}


if __name__ == "__main__":
    ROLES[os.environ["ROLE"]]()

"""Process roles of a parameter-server job (the port's counterpart of
``scripts/widedeep_ps_bench.py`` and of the JAX package's test
fixtures): one process per role, configured by the environment.

    python -m paddle_tpu_torch.distributed.fleet.ps_roles

ROLE=server     a PSServer shard on MY_ENDPOINT until killed. The
                snapshot tier, the row-level WAL (PADDLE_PS_WAL), hot
                standbys (PADDLE_PS_HA_PRIMARY / _EPOCH / _SEMISYNC),
                the tiered store (PADDLE_PS_TIER_*) and fault
                injection (PADDLE_PS_FAULT_*: KILL_AFTER with
                KILL_POINT=reply kills a primary after a commit and
                before its reply) read their own knobs. Prints one
                ready line, JSON: {"endpoint", "restored", "native",
                "pid", "role", "epoch", "wal", "tier"} ("native": the
                shard's untiered tables run on the C++ core; "tier":
                the warm budget in bytes and the tiered tables, or
                null).
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
ROLE=runner     the worker recipe (WORKER_ID 0, no profiled step) for
                several runs on one CUDA context, the local step under
                torch.use_deterministic_algorithms (CUBLAS_WORKSPACE_CONFIG
                defaults to :4096:8): each stdin line is a JSON run
                {"tag", "endpoints", "tables_out"} (endpoints: one
                entry a shard, "primary|standby" for an HA group); the
                run trains a fresh worker on fresh batches, writes the
                touched rows of embed and wide and every dense table to
                tables_out (npz) and prints one JSON line: the worker's
                figures, each push's start and end (time.time()), the
                client's failovers, redirects and cold faults.
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
learnable CTR batches, read a run's tables back; an HA group's
processes, its status, promotion when its primary dies, a runner's
runs) serve ``chip_smoke.py`` and the port's tests.
"""
from __future__ import annotations

import json
import os
import select
import statistics
import subprocess
import sys
import threading
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


def spawn(stdin=None, stderr=subprocess.PIPE, **kw) -> subprocess.Popen:
    """One role process; `kw` is its environment (ROLE=...). The caller
    gives it a timeout and stops it in a ``finally``."""
    return subprocess.Popen([sys.executable, "-m", __spec__.name],
                            env=role_env(**kw), cwd=REPO, stdin=stdin,
                            stdout=subprocess.PIPE, stderr=stderr,
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


def spawn_ha_group(primary: str, standby: str, root: str,
                   primary_env: dict | None = None, **kw):
    """A WAL-on primary on `primary` and its hot standby on `standby`,
    each with its snapshot dir under `root`, started together (the
    standby's replicator retries until the primary listens); `kw` goes
    to both, `primary_env` to the primary alone. Returns the two
    processes and their ready lines."""
    def snap(ep):
        return os.path.join(root, ep.replace(":", "_"))
    procs = [spawn(ROLE="server", MY_ENDPOINT=primary, PADDLE_PS_WAL=1,
                   PADDLE_PS_SNAPSHOT_DIR=snap(primary),
                   **dict(kw, **(primary_env or {}))),
             spawn(ROLE="server", MY_ENDPOINT=standby, PADDLE_PS_WAL=1,
                   PADDLE_PS_SNAPSHOT_DIR=snap(standby),
                   PADDLE_PS_HA_PRIMARY=primary, **kw)]
    try:
        return procs, [ready(p) for p in procs]
    except BaseException:
        stop(procs)
        raise


def ha_status(ep: str, timeout: float = 2.0) -> dict:
    """One shard's ``ha_status`` (role, epoch, applied / published
    sequence, attached standbys and their lag in records)."""
    from .runtime.rpc import RpcClient
    cl = RpcClient(ep, timeout=timeout, deadline=timeout + 1.0,
                   max_retries=0)
    try:
        return cl.call({"op": "ha_status"}, timeout=timeout)
    finally:
        cl.close()


def wait_standbys(groups, timeout: float = 60.0):
    """Block until every ``primary|standby`` group's standby is attached
    to its primary and has imported its bootstrap."""
    deadline = time.monotonic() + timeout
    for g in groups:
        prim, stby = g.split("|")
        while True:
            try:
                peers = {s["peer"] for s in ha_status(prim)["standbys"]
                         if not s["broken"]}
                if stby in peers and ha_status(stby)["synced"]:
                    break
            except Exception:
                pass
            if time.monotonic() > deadline:
                raise TimeoutError(f"standby {stby} never attached to "
                                   f"{prim}")
            time.sleep(0.05)


def metric_sum(ep: str, name: str, **labels) -> float:
    """A shard's series `name` (matching `labels`), summed, from its
    ``metrics`` verb."""
    from .runtime.rpc import RpcClient
    cl = RpcClient(ep, timeout=5.0, deadline=6.0, max_retries=0)
    try:
        text = cl.call({"op": "metrics"})
    finally:
        cl.close()
    want = [f'{k}="{v}"' for k, v in labels.items()]
    total = 0.0
    for line in text.splitlines():
        if line.startswith(name + "{") or line.startswith(name + " "):
            if all(w in line for w in want):
                total += float(line.rsplit(" ", 1)[1])
    return total


class PromoteOnDeath:
    """Watch a primary's process; when it exits, promote the most
    caught-up of `standbys` at `epoch` (``ps_ha.promote_best``), as a
    launcher's failover does. ``kill_t`` is the time.time() the death
    was seen (polled every 2 ms), ``promoted`` the endpoint that took
    over (None if none answered), ``code`` the primary's exit code."""

    def __init__(self, proc: subprocess.Popen, standbys, epoch: int,
                 timeout: float = 300.0):
        self.proc, self.standbys, self.epoch = proc, list(standbys), epoch
        self.kill_t = self.promote_t = self.code = self.promoted = None
        self.error = None
        self._stop = threading.Event()
        self._deadline = time.monotonic() + timeout
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        from .runtime.ps_ha import promote_best
        try:
            while not self._stop.is_set():
                if self.proc.poll() is not None:
                    self.kill_t = time.time()
                    self.code = self.proc.returncode
                    self.promoted = promote_best(self.standbys, self.epoch)
                    self.promote_t = time.time()
                    return
                if time.monotonic() > self._deadline:
                    return
                time.sleep(0.002)
        except BaseException as e:  # read by the caller
            self.error = e

    def close(self):
        self._stop.set()
        self._thread.join(timeout=30)


class Runner:
    """A ROLE=runner process: one CUDA context for several runs. `env`
    is its environment (DEVICE, CONFIG, BATCH, WARMUP, STEPS); its
    stderr goes to `log`."""

    def __init__(self, log: str, **env):
        self._log = open(log, "w")
        self.proc = spawn(stdin=subprocess.PIPE, stderr=self._log,
                          ROLE="runner", **env)

    def run(self, timeout: float = 240.0, **spec) -> dict:
        """One run (tag, endpoints, tables_out) and its JSON line."""
        self.proc.stdin.write(json.dumps(spec) + "\n")
        self.proc.stdin.flush()
        if not select.select([self.proc.stdout], [], [], timeout)[0]:
            raise TimeoutError(f"PS run {spec.get('tag')} gave no line "
                               f"in {timeout} s")
        line = self.proc.stdout.readline()
        if not line:
            self._log.flush()
            with open(self._log.name) as f:
                tail = f.read()[-3000:]
            raise RuntimeError(f"PS runner exited (code "
                               f"{self.proc.poll()}): {tail}")
        return json.loads(line)

    def close(self):
        try:
            if self.proc.poll() is None:
                self.proc.stdin.close()
                self.proc.wait(timeout=30)
        except Exception:
            pass
        finally:
            stop([self.proc])
            self._log.close()


def free_endpoints(n: int) -> list[str]:
    """`n` free localhost endpoints."""
    from ..spawn import _free_ports
    return [f"127.0.0.1:{p}" for p in _free_ports(n)]


def _tables_of(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def ha_run(runner: Runner, root: str, tag: str, shards: int = 2,
           semisync: int = 1, kill_after: int = 0,
           sample_s: float = 0.02) -> dict:
    """One runner run over `shards` fresh HA groups (a WAL-on primary
    and one standby each, PADDLE_PS_HA_SEMISYNC=`semisync`), started
    and attached before the run. With `kill_after`, shard 0's primary
    dies after that many requests, after a commit and before its reply,
    and PromoteOnDeath promotes its standby at epoch 2; otherwise the
    primaries' replication lag (records shipped and not acked, the
    largest over the standbys) is sampled every `sample_s` seconds
    through the run, then the seconds until it drains to 0, and the
    requests shard 0's primary received (the worker's, the standby's
    replication calls and the status polls before the run; not the lag
    sampler's). Returns the runner's line, the tables it pulled back,
    and those figures."""
    eps = free_endpoints(2 * shards)
    groups = [f"{eps[2 * i]}|{eps[2 * i + 1]}" for i in range(shards)]
    prims = eps[0::2]
    env = dict(PADDLE_PS_HA_SEMISYNC=semisync,
               PADDLE_PS_HA_SEMISYNC_TIMEOUT=10)
    kill = dict(PADDLE_PS_FAULT_KILL_AFTER=kill_after,
                PADDLE_PS_FAULT_KILL_POINT="reply")
    procs, readies, watch, lags, probes = [], [], None, [], [0]
    out_path = os.path.join(root, f"{tag}.npz")
    try:
        for i in range(shards):
            p, s = groups[i].split("|")
            ps, rs = spawn_ha_group(p, s, os.path.join(root, tag),
                                    primary_env=kill if kill_after
                                    and i == 0 else None, **env)
            procs += ps
            readies += rs
        wait_standbys(groups)
        if kill_after:
            watch = PromoteOnDeath(procs[0], [eps[1]], epoch=2)
            line = runner.run(tag=tag, endpoints=groups,
                              tables_out=out_path)
        else:
            done = threading.Event()

            def sample():
                while not done.wait(sample_s):
                    try:
                        lags.append(max(s["lag_rows"] for ep in prims
                                        for s in ha_status(ep)
                                        ["standbys"]))
                        probes[0] += 1
                    except Exception:
                        pass

            th = threading.Thread(target=sample, daemon=True)
            th.start()
            try:
                line = runner.run(tag=tag, endpoints=groups,
                                  tables_out=out_path)
            finally:
                done.set()
                th.join(timeout=30)
        if not kill_after:
            # shard 0's requests, less the lag sampler's probes and
            # this metrics call itself
            requests = int(metric_sum(
                eps[0], "paddle_tpu_rpc_server_requests_total")) \
                - probes[0] - 1
        t0 = time.perf_counter()
        live = [ep for ep in prims if not (kill_after and ep == eps[0])]
        while any(s["lag_rows"] for ep in live
                  for s in ha_status(ep)["standbys"]):
            if time.perf_counter() - t0 > 60:
                raise TimeoutError("replication lag never drained")
            time.sleep(0.001)
        drain_s = time.perf_counter() - t0
        res = {"line": line, "tables": _tables_of(out_path),
               "lag_rows": lags, "drain_s": drain_s, "groups": groups,
               "ready": readies}
        if watch is not None:
            watch.close()
            if watch.error is not None:
                raise watch.error
            res.update(kill_t=watch.kill_t, promote_t=watch.promote_t,
                       killed_code=watch.code, promoted=watch.promoted,
                       standby_status=ha_status(eps[1]))
        else:
            res["requests"] = requests
        return res
    finally:
        if watch is not None:
            watch.close()
        stop(procs)


def tier_run(runner: Runner, root: str, tag: str, budgets=None,
             tables: str = "embed") -> dict:
    """One runner run over two fresh shards on the numpy path (a tiered
    table and an all-warm one draw the same init rows only there). With
    `budgets` (warm bytes, one a shard), `tables` are tiered, their cold
    rows in a chunk store under `root`. Returns the runner's line, the
    tables it pulled back, and each shard's embed rows, and, tiered,
    its cold faults, demotions (clean / flush) and warm / cold rows."""
    eps = free_endpoints(2)
    procs = []
    out_path = os.path.join(root, f"{tag}.npz")
    try:
        for i, ep in enumerate(eps):
            kw = dict(PADDLE_TPU_DISABLE_NATIVE=1)
            if budgets:
                kw.update(PADDLE_PS_TIER_WARM_BYTES=int(budgets[i]),
                          PADDLE_PS_TIER_TABLES=tables,
                          PADDLE_PS_TIER_STORE_DIR=os.path.join(
                              root, tag, ep.replace(":", "_")))
            procs.append(spawn(ROLE="server", MY_ENDPOINT=ep, **kw))
        for p in procs:
            ready(p)
        line = runner.run(tag=tag, endpoints=eps, tables_out=out_path)
        from .runtime.parameter_server_runtime import PSClient
        shards = []
        for ep in eps:
            cl = PSClient([ep])
            try:
                info = {"embed_rows": cl.size("embed")}
            finally:
                cl.close()
            if budgets:
                m = "paddle_tpu_ps_tier_"
                info.update(
                    cold_faults=int(metric_sum(ep, m + "faults_total")),
                    demoted_clean=int(metric_sum(
                        ep, m + "demotions_total", kind="clean")),
                    demoted_flush=int(metric_sum(
                        ep, m + "demotions_total", kind="flush")),
                    warm_rows=int(metric_sum(ep, m + "resident_rows",
                                             tier="warm")),
                    cold_rows=int(metric_sum(ep, m + "resident_rows",
                                             tier="cold")),
                    cold_read_errors=int(metric_sum(
                        ep, m + "cold_read_errors_total")))
            shards.append(info)
        return {"line": line, "tables": _tables_of(out_path),
                "shards": shards}
    finally:
        stop(procs)


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


def run_tables(fw, worker, cfg, ids=None) -> dict:
    """Every table of a wide&deep run, pulled back through `fw`: embed
    and wide at `ids` (default: ``ctr_batches``' ids), the dense tables
    whole."""
    if ids is None:
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
    tier = None
    if server.tier_warm_bytes > 0:
        tier = {"warm_bytes": server.tier_warm_bytes,
                "tables": sorted(server.tier_tables) or "all"}
    print(json.dumps({"endpoint": server.endpoint,
                      "restored": bool(server.snapshot_dir
                                       and server.tables),
                      "native": LargeScaleKV(1)._native is not None,
                      "pid": os.getpid(), "role": server.ha_role,
                      "epoch": server.shard_epoch,
                      "wal": server.wal_enabled, "tier": tier}),
          flush=True)
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


def _recorded(data, touched: list):
    """`data`'s batches, each batch's unique ids appended to `touched`."""
    for b in data:
        touched.append(np.unique(b[0]))
        yield b


def _run(fw, kv, dev, cfg, wid: int, data, profile: bool = False):
    """One Downpour run over `fw` (through `kv`: the BoxPS cache, or fw
    itself) on `data`'s batches: a fresh worker (worker 0 seeds the
    dense tables), WARMUP steps, with `profile` one step under
    torch.profiler, then STEPS timed steps from the fetch barrier among
    WORKERS on. Returns the worker and its figures."""
    import torch

    from ...ops import launch_counts
    from .fleet_wrapper import DownpourWorker
    steps = int(_env("STEPS", "8"))
    batch = int(_env("BATCH", "4096"))
    worker = DownpourWorker(kv, cfg, lr=0.05, device=dev)
    if wid == 0:
        worker.push_initial_dense()
    else:
        time.sleep(1.0)   # let worker 0 seed the dense tables

    def step():
        worker.train_one_batch(*next(data))

    for _ in range(int(_env("WARMUP", "1"))):
        step()
    busy = busy_ms(torch, step) if profile and dev.type == "cuda" \
        else None
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
           "push_ms_each": [t["push_s"] * 1e3 for t in tm],
           "busy_ms": busy,
           "busy_share": None if busy is None
           else busy / med_ms("step_s"),
           "losses": worker._losses,
           "port_launches": launch_counts()}
    if dev.type == "cuda":
        out["max_memory_allocated_gb"] = \
            torch.cuda.max_memory_allocated() / 1e9
    return worker, out


def work():
    from .fleet_wrapper import FleetWrapper
    dev = _device()
    wid = int(_env("WORKER_ID", "0"))
    cfg = _config()
    fw = FleetWrapper(endpoints=os.environ["PS_ENDPOINTS"].split(","))
    kv = fw
    if _env("MODE", "") == "boxps":
        from .boxps_cache import BoxPSWrapper
        kv = BoxPSWrapper(fw, capacity=1 << 21,
                          flush_every=int(_env("FLUSH_EVERY", "8")))
    _, out = _run(fw, kv, dev, cfg, wid,
                  zipf_batches(cfg, int(_env("BATCH", "4096")), wid),
                  profile=True)
    if kv is not fw:
        out["cache_hits"] = kv.cache_hits
        out["cache_misses"] = kv.cache_misses
    fw.stop()
    print(json.dumps(out), flush=True)


def runner():
    """ROLE=runner: one run a stdin line (see the module's docstring)."""
    # cuBLAS reads its workspace setting when the process first uses it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    from ...ops import reset_launch_counts
    from .fleet_wrapper import FleetWrapper
    dev = _device()
    torch.use_deterministic_algorithms(True)
    cfg = _config()
    for line in sys.stdin:
        spec = json.loads(line)
        reset_launch_counts()
        fw = FleetWrapper(endpoints=spec["endpoints"])
        cl = fw._client
        pushes = []
        push = cl.push

        def timed_push(*a, **kw):
            t0 = time.time()
            push(*a, **kw)
            pushes.append((t0, time.time()))

        cl.push = timed_push
        touched = []
        worker, out = _run(fw, fw, dev, cfg, 0, _recorded(zipf_batches(
            cfg, int(_env("BATCH", "4096")), 0), touched))
        if spec.get("tables_out"):
            ids = np.unique(np.concatenate(touched))
            np.savez(spec["tables_out"], ids=ids,
                     **run_tables(fw, worker, cfg, ids))
        out.update(tag=spec.get("tag"), pushes=pushes,
                   failovers=cl.failovers, redirects=cl.redirects,
                   fenced_rejects=cl.fenced_rejects,
                   cold_faults=cl.cold_faults)
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


ROLES = {"server": serve, "worker": work, "runner": runner,
         "trainer": train, "heter_cpu": heter_cpu}


if __name__ == "__main__":
    ROLES[os.environ["ROLE"]]()

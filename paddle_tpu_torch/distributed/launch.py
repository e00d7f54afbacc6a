"""Process launcher — ``python -m paddle_tpu_torch.distributed.launch``
(counterpart of ``paddle_tpu/distributed/launch.py``).

Reference: python/paddle/distributed/launch.py:59,140,214 (parse ips/ports
-> Cluster/Pod -> start_local_trainers sets PADDLE_* env, spawns children,
watches and tears all down on failure) and fleet/launch.py (fleetrun, adds
--servers/--workers PS mode).

Rendezvous: every trainer child gets the PADDLE_* env of
``get_cluster_env``; ``PADDLE_COORDINATOR`` is the first trainer
endpoint. The JAX package hands it to ``jax.distributed``; the port's
``distributed.env.init_parallel_env`` joins a ``torch.distributed``
process group at ``tcp://PADDLE_COORDINATOR`` instead, over ``gloo`` on
the CPU and when ranks share a card, ``nccl`` when each rank has a card
of its own. Rank 0 binds that port, so ``--started_port`` (or
``--trainer_endpoints``) must name free ports; a restarted gang binds
the same ones again.

Elastic mode (``--max_restarts``): a crashed or hung trainer tears the
gang down and the job restarts (children resume from their cluster
checkpoint, ``distributed/cluster_ckpt.py``); a dead PS shard or serving
replica restarts alone; a dead HA primary is replaced by its best
standby. When several children are found dead at one poll, the one that
exited FIRST is blamed: with real collectives a rank's death makes its
peers fail a moment later, and the flap and crash-loop accounting must
name the rank that died, not its victims.

Online learning and telemetry: ``--publish_dir`` hands
PADDLE_TPU_PUBLISH_DIR to the PS server and serving-replica children
(servers publish their tables there, replicas adopt from it);
``--telemetry`` points every child's agent at a ``telemetry`` child
running ``python -m paddle_tpu_torch.observability.collector``, which
the watch loop respawns alone, and ``--tsdb-dir`` gives that collector
its durable metric history; the serving router
(``paddle_tpu_torch.serving.router``) fronts the ``--serving_replicas``
children, and ``python -m paddle_tpu_torch.observability.top`` reads
the collector.
"""
from __future__ import annotations

import argparse
import os
import shutil
import signal
import subprocess
import sys
import threading
import time

__all__ = ["launch", "main", "get_cluster_env"]


def _parse(argv):
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch",
        description="launch multi-process distributed training")
    p.add_argument("--nproc_per_node", type=int, default=None,
                   help="trainers on this node (default: 1, or inferred "
                        "from --trainer_endpoints)")
    p.add_argument("--ips", type=str, default="127.0.0.1",
                   help="comma-separated node ips (this launcher starts "
                        "only the local node's processes)")
    p.add_argument("--node_rank", type=int, default=0)
    p.add_argument("--started_port", type=int, default=6170)
    p.add_argument("--trainer_endpoints", type=str, default=None,
                   help="explicit comma-separated endpoints (overrides "
                        "ips/started_port)")
    p.add_argument("--servers", type=str, default="",
                   help="PS mode: comma-separated server endpoints")
    p.add_argument("--workers", type=str, default="",
                   help="PS mode: comma-separated worker endpoints")
    p.add_argument("--serving_replicas", type=str, default="",
                   help="serving mode: comma-separated replica "
                        "endpoints; spawns one child per endpoint with "
                        "PADDLE_TPU_REPLICA_ENDPOINT / "
                        "PADDLE_TPU_REPLICA_ID set (the script builds "
                        "Engine.from_checkpoint + ServingServer on that "
                        "endpoint). With --max_restarts > 0 a dead "
                        "replica is respawned ALONE — its state lives "
                        "in the engine checkpoint")
    p.add_argument("--log_dir", type=str, default=None)
    p.add_argument("--max_restarts", type=int, default=0,
                   help="elastic: restart the whole job up to N times "
                        "after a crashed or hung rank (children resume "
                        "from their checkpoints)")
    p.add_argument("--heartbeat_timeout", type=float, default=30.0,
                   help="elastic: seconds without a heartbeat before a "
                        "rank counts as hung (ranks opt in via "
                        "distributed.elastic.start_heartbeat)")
    p.add_argument("--step_deadline", type=float, default=0.0,
                   help="elastic: seconds a rank's heartbeat STEP "
                        "counter may freeze (while still beating) "
                        "before it counts as hung — catches wedged "
                        "collectives a live heartbeat thread hides. "
                        "0 disables; ranks report steps via "
                        "distributed.elastic.note_step")
    p.add_argument("--straggler_lag", type=int, default=10,
                   help="elastic: steps behind the fastest rank before "
                        "a slow-but-progressing rank is flagged "
                        "(paddle_tpu_elastic_straggler_ranks metric + "
                        "flight event). Stragglers are NEVER killed")
    p.add_argument("--restart_backoff", type=float, default=1.0,
                   help="elastic: base seconds of exponential backoff "
                        "between whole-job restarts (doubles per "
                        "restart, capped by --restart_backoff_max; "
                        "0 restarts immediately)")
    p.add_argument("--restart_backoff_max", type=float, default=30.0)
    p.add_argument("--crash_loop_window", type=float, default=60.0,
                   help="elastic: sliding window (seconds) for crash-"
                        "loop detection")
    p.add_argument("--crash_loop_threshold", type=int, default=0,
                   help="elastic: give up once this many job failures "
                        "land inside --crash_loop_window even with "
                        "restart budget left, and write a debug "
                        "bundle naming the flapping rank (0 disables)")
    p.add_argument("--exclude_flapping", action="store_true",
                   help="elastic: after a trainer rank fails "
                        "--flap_threshold times, respawn the job at "
                        "world W-1 WITHOUT it (ranks renumber; "
                        "children resume via the cluster-checkpoint "
                        "resize path)")
    p.add_argument("--flap_threshold", type=int, default=2,
                   help="elastic: failures by one rank before "
                        "--exclude_flapping drops it")
    p.add_argument("--cluster_ckpt_dir", type=str, default=None,
                   help="elastic: set PADDLE_TPU_CLUSTER_CKPT_DIR for "
                        "every child — the coordinated cluster-"
                        "checkpoint store (distributed/cluster_ckpt) "
                        "restarts resume from. NEVER cleared between "
                        "restarts (it IS the cross-life state)")
    p.add_argument("--ps_snapshot_dir", type=str, default=None,
                   help="PS mode: server snapshot directory "
                        "(PADDLE_PS_SNAPSHOT_DIR for the children); "
                        "with --max_restarts > 0 a dead server is "
                        "respawned ALONE from its snapshot instead of "
                        "restarting the whole job. The dir is CLEARED "
                        "at every job(-re)start — snapshots are "
                        "intra-job fault tolerance (workers replay "
                        "from scratch on a full restart; resuming "
                        "stale tables would double-apply their "
                        "pushes); use save/load_model for cross-job "
                        "resume. Default: a temp dir when PS-mode "
                        "elastic restarts are enabled")
    p.add_argument("--ps_snapshot_every", type=int, default=1,
                   help="PS mode: snapshot the server tables every N "
                        "applied pushes (PADDLE_PS_SNAPSHOT_EVERY). "
                        "Default 1 = write-through: a respawned server "
                        "loses NO acknowledged push. N>1 trades that "
                        "durability for throughput — a crash can "
                        "silently drop up to N-1 acked pushes on "
                        "respawn")
    p.add_argument("--ps_tier_warm_bytes", type=int, default=0,
                   help="PS mode: opt server tables into the tiered "
                        "embedding store with "
                        "this warm-tier RAM budget in bytes per table "
                        "(PADDLE_PS_TIER_WARM_BYTES for server/"
                        "standby children; 0 = all-warm tables). "
                        "Cold rows demand-page from a chunk store "
                        "under the snapshot dir (or "
                        "--ps_tier_store_dir)")
    p.add_argument("--ps_tier_store_dir", type=str, default=None,
                   help="PS mode: cold-tier chunk store directory "
                        "(PADDLE_PS_TIER_STORE_DIR). Default: "
                        "<snapshot_dir>/tier_store")
    p.add_argument("--publish_dir", type=str, default=None,
                   help="online learning: set PADDLE_TPU_PUBLISH_DIR "
                        "for PS server and serving-replica children. "
                        "Servers export their tables through the "
                        "publish pipeline on the PADDLE_TPU_PUBLISH_"
                        "EVERY_* cadence; replicas adopt published "
                        "versions from it")
    p.add_argument("--metrics_dir", type=str, default=None,
                   help="telemetry: set PADDLE_TPU_METRICS_DIR for "
                        "every child so each process dumps its metric "
                        "registry to <dir>/metrics_<host>_<pid>.json "
                        "at exit")
    p.add_argument("--debug_dir", type=str, default=None,
                   help="postmortem: set PADDLE_TPU_DEBUG_DIR for "
                        "every child so each process writes a debug "
                        "bundle (metrics + trace ring + flight "
                        "recorder + in-flight requests, CRC'd "
                        "manifest) on SIGTERM, unhandled exceptions "
                        "and watchdog stalls — including the teardown "
                        "this launcher runs when a rank dies or hangs; "
                        "a crash-loop give-up writes one too")
    p.add_argument("--telemetry", type=str, default=None,
                   nargs="?", const="127.0.0.1:8600",
                   metavar="HOST:PORT",
                   help="fleet telemetry: spawn a collector child on "
                        "this endpoint (default 127.0.0.1:8600 when "
                        "the flag is given bare) and set "
                        "PADDLE_TPU_TELEMETRY_COLLECTOR for every "
                        "other child so each process streams spans / "
                        "flight events / metric deltas to it")
    p.add_argument("--tsdb-dir", type=str, default=None,
                   metavar="DIR",
                   help="with --telemetry: durable metric history — "
                        "the collector child persists its TSDB blocks "
                        "here (PADDLE_TPU_TSDB_DIR), so its history "
                        "and SLO burn-rate alerts survive collector "
                        "restarts; without it history is memory-only")
    p.add_argument("training_script", type=str)
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def get_cluster_env(rank, endpoints, role="TRAINER", servers="",
                    workers=""):
    """PADDLE_* env for one child (reference launch_utils.py
    start_local_trainers)."""
    env = {
        "PADDLE_TRAINER_ID": str(rank),
        "PADDLE_CURRENT_ENDPOINT": endpoints[rank],
        "PADDLE_TRAINERS_NUM": str(len(endpoints)),
        "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
        "PADDLE_COORDINATOR": endpoints[0],
        "TRAINING_ROLE": role,
        "FLAGS_selected_gpus": "0",
    }
    if servers:
        env["PADDLE_PSERVERS_IP_PORT_LIST"] = servers
    if workers:
        env["PADDLE_WORKERS_IP_PORT_LIST"] = workers
    return env


def _stamp_exit(p):
    """Reap ``p`` and note when it exited (``p.exited_at``, monotonic):
    the watch loop polls every 0.2 s, too coarse to tell which of two
    dead ranks died first."""
    p.wait()
    p.exited_at = time.monotonic()


def _exit_order(entry):
    """Sort key of a child: its exit time, inf while it runs."""
    p = entry[1]
    if p.returncode is None:
        return float("inf")
    return getattr(p, "exited_at", time.monotonic())


def _spawn_one(name, env_over, argv, log_dir):
    env = dict(os.environ)
    env.update(env_over)
    if log_dir:
        fh = open(os.path.join(log_dir, f"{name}.log"), "a")
        stdout = stderr = fh
    else:
        fh, stdout, stderr = None, None, None
    p = subprocess.Popen(argv, env=env, stdout=stdout, stderr=stderr)
    threading.Thread(target=_stamp_exit, args=(p,), daemon=True,
                     name=f"reap-{name}").start()
    return [name, p, fh]


def _spawn_children(specs, log_dir):
    """specs: list of (name, env_overrides, argv). Returns proc list."""
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
    return [_spawn_one(name, env_over, argv, log_dir)
            for name, env_over, argv in specs]


def _build_ha_state(ha_members):
    """Per-HA-shard failover bookkeeping for _watch: current epoch,
    which child name is primary, and every member's endpoint. Only
    shards with standbys participate (single-member shards keep the
    snapshot-respawn path)."""
    ha_state, name_shard = {}, {}
    for i, members in enumerate(ha_members or []):
        if len(members) < 2:
            continue
        st = {"epoch": 1, "primary": f"server.{i}", "members": {}}
        for j, ep in enumerate(members):
            name = f"server.{i}" if j == 0 else f"standby.{i}.{j}"
            st["members"][name] = ep
            name_shard[name] = i
        ha_state[i] = st
    return ha_state, name_shard


def _watch(procs, manager=None, specs=None, log_dir=None,
           rank_names=None, ha_state=None, name_shard=None):
    """Poll children; on failure or a hung heartbeat kill the rest
    (reference launch.py:214 watch + terminate_local_trainers). Returns
    (rc, needs_restart, offender, reason): the elastic loop in
    `launch` respawns when the manager still has restarts left;
    `offender` is the child name that triggered the teardown (crash or
    first hung rank, None otherwise) and `reason` is "crash" | "hang".

    Graceful degradation: when `specs` carries a respawnable child —
    a `server.*` PS shard (restores from its snapshot) or a
    `replica.*` serving replica (rebuilds from its engine checkpoint;
    the router fails its in-flight work over meanwhile) — and the
    manager still has single-child restart budget, ONLY that child is
    respawned instead of the whole job. Children are visited in the
    order they exited, so the offender of a gang that fell together is
    the rank that died first. Step-lag stragglers are reported once
    (stderr + the manager's metrics/flight event), never killed."""
    specs = specs or {}
    rank_names = rank_names or {}
    name_shard = name_shard or {}
    slow_reported: set = set()
    ha_handled: set = set()  # dead HA members deliberately left down
    try:
        while True:
            alive = False
            for entry in sorted(procs, key=_exit_order):
                name, p, fh = entry
                rc = p.poll()
                if rc is None:
                    alive = True
                elif rc != 0:
                    if name in ha_handled:
                        continue
                    spec = specs.get(name)
                    shard = name_shard.get(name)
                    if shard is not None:
                        done = _ha_member_died(
                            entry, rc, ha_state[shard], shard, spec,
                            specs, manager, log_dir, ha_handled)
                        if done:
                            alive = True
                            continue
                        # shard unrecoverable: fall through to teardown
                    if spec is not None and manager is not None \
                            and (name.startswith(("server.", "replica."))
                                 or name == "telemetry") \
                            and manager.should_restart_server():
                        manager.record_server_restart()
                        if name.startswith("server."):
                            what = "it from snapshot"
                        elif name == "telemetry":
                            what = "the stateless collector alone"
                        else:
                            what = "it alone from its engine checkpoint"
                        sys.stderr.write(
                            f"[launch] {name} exited with code {rc}; "
                            f"restarting {what} "
                            f"({manager.server_restart_count}/"
                            f"{manager.max_server_restarts})\n")
                        if fh:
                            fh.close()
                        entry[:] = _spawn_one(name, spec[0], spec[1],
                                              log_dir)
                        alive = True
                        continue
                    sys.stderr.write(
                        f"[launch] {name} exited with code {rc}; "
                        f"terminating the job\n")
                    _kill_all(procs)
                    return rc, True, name, "crash"
            if not alive:
                return 0, False, None, None
            # PS mode: servers run forever — the job is DONE when every
            # worker/trainer child finished cleanly (reference fleetrun
            # tears servers down once trainers exit)
            worker_rcs = [p.poll() for name, p, _ in procs
                          if not name.startswith(
                              ("server.", "standby.", "replica."))
                          and name != "telemetry"]
            if worker_rcs and all(rc == 0 for rc in worker_rcs) \
                    and any(name.startswith(("server.", "standby."))
                            or name == "telemetry"
                            for name, _, _ in procs):
                sys.stderr.write(
                    "[launch] all workers finished; stopping daemon "
                    "children (PS servers / telemetry)\n")
                _kill_all(procs)
                return 0, False, None, None
            if manager is not None:
                hung = manager.hung_ranks()
                if hung:
                    sys.stderr.write(
                        f"[launch] ranks {hung} missed heartbeats for "
                        f">{manager.heartbeat_timeout}s; terminating the "
                        f"job\n")
                    _kill_all(procs)
                    return 1, True, \
                        rank_names.get(hung[0], f"rank{hung[0]}"), \
                        "hang"
                for r in manager.stragglers():
                    if r not in slow_reported:
                        slow_reported.add(r)
                        sys.stderr.write(
                            f"[launch] rank {r} lags "
                            f">{manager.straggler_lag} steps behind "
                            f"the fastest rank (straggler — flagged, "
                            f"not killed)\n")
            time.sleep(0.2)
    except KeyboardInterrupt:
        _kill_all(procs)
        return 1, False, None, None
    finally:
        for _, _, fh in procs:
            if fh:
                fh.close()


def _ha_member_died(entry, rc, st, shard, spec, specs, manager,
                    log_dir, ha_handled):
    """One member of an HA PS shard exited. A dead PRIMARY is fenced
    out by promoting the most-caught-up live standby with a bumped
    epoch — failover costs no restart budget and no snapshot replay.
    The dead member is then respawned as a fresh standby of the
    current primary (budget-counted); with no budget left the shard
    keeps running on its survivors. Returns True when the shard is
    still served (the caller keeps watching), False when it is lost
    (no live member, no respawn budget) and the job must tear down."""
    name = entry[0]
    if name == st["primary"]:
        from .fleet.runtime.ps_ha import promote_best
        others = [ep for n, ep in st["members"].items() if n != name]
        promoted = promote_best(others, st["epoch"] + 1)
        if promoted is not None:
            st["epoch"] += 1
            st["primary"] = next(n for n, ep in st["members"].items()
                                 if ep == promoted)
            sys.stderr.write(
                f"[launch] {name} (PS shard {shard} primary) exited "
                f"with code {rc}; promoting standby {promoted} "
                f"(epoch {st['epoch']})\n")
    shard_alive = st["primary"] != name
    if spec is not None and manager is not None \
            and manager.should_restart_server():
        manager.record_server_restart()
        env2 = dict(spec[0])
        if shard_alive:
            env2["PADDLE_PS_HA_PRIMARY"] = st["members"][st["primary"]]
            env2.pop("PADDLE_PS_HA_EPOCH", None)
            what = (f"respawning it as a standby of "
                    f"{st['members'][st['primary']]}")
        else:
            # no standby answered the promotion probe: bring the dead
            # primary itself back at the current epoch
            env2.pop("PADDLE_PS_HA_PRIMARY", None)
            env2["PADDLE_PS_HA_EPOCH"] = str(st["epoch"])
            what = "restarting it from snapshot"
        sys.stderr.write(
            f"[launch] {name} exited with code {rc}; {what} "
            f"({manager.server_restart_count}/"
            f"{manager.max_server_restarts})\n")
        specs[name] = (env2, spec[1])
        if entry[2]:
            entry[2].close()
        entry[:] = _spawn_one(name, env2, spec[1], log_dir)
        return True
    if shard_alive:
        # no respawn budget, but a promoted/live member carries the
        # shard — leave this member down and keep the job running
        ha_handled.add(name)
        sys.stderr.write(
            f"[launch] {name} exited with code {rc}; shard {shard} "
            f"continues on {st['members'][st['primary']]} "
            f"(no respawn budget left)\n")
        return True
    return False


def _kill_all(procs):
    for _, p, _ in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.time() + 5
    for _, p, _ in procs:
        while p.poll() is None and time.time() < deadline:
            time.sleep(0.05)
        if p.poll() is None:
            p.kill()


def launch(argv=None):
    args = _parse(argv if argv is not None else sys.argv[1:])
    script = [sys.executable, args.training_script] \
        + args.training_script_args
    specs = []
    ha_members: list[list[str]] = []
    if args.servers or args.workers:
        # PS mode (fleetrun --servers/--workers). A server entry may be
        # a |-joined HA group, primary|standby[|standby2]: member 0
        # starts as the shard primary, the rest as hot standbys
        # replicating its WAL. Workers receive the raw group string and
        # route pushes to ONE active member per shard.
        servers = [e for e in args.servers.split(",") if e]
        workers = [e for e in args.workers.split(",") if e]
        ha_members = [s.split("|") for s in servers]
        for i, members in enumerate(ha_members):
            for j, ep in enumerate(members):
                env = get_cluster_env(0, workers or ["127.0.0.1:6170"],
                                      role="PSERVER",
                                      servers=args.servers,
                                      workers=args.workers)
                # a server's identity is its OWN endpoint/index, not
                # worker 0's (the trainer fields above only give
                # servers the cluster layout)
                env.update({"PADDLE_CURRENT_ENDPOINT": ep,
                            "PADDLE_PORT": ep.rsplit(":", 1)[1],
                            "POD_IP": ep.rsplit(":", 1)[0],
                            "PADDLE_SERVER_ID": str(i)})
                if len(members) > 1:
                    # HA shard: replication ships WAL records, so the
                    # row journal is mandatory; the starting primary
                    # opens at epoch 1 so fencing can tell its zombies
                    # from a promoted successor
                    env["PADDLE_PS_WAL"] = "1"
                    if j == 0:
                        env["PADDLE_PS_HA_EPOCH"] = "1"
                    else:
                        env["PADDLE_PS_HA_PRIMARY"] = members[0]
                name = f"server.{i}" if j == 0 \
                    else f"standby.{i}.{j}"
                specs.append((name, env, script))
        for i, ep in enumerate(workers):
            env = get_cluster_env(i, workers, role="TRAINER",
                                  servers=args.servers,
                                  workers=args.workers)
            specs.append((f"worker.{i}", env, script))
    elif args.serving_replicas:
        # serving fleet: one replica child per endpoint, identity via
        # env (the script builds Engine.from_checkpoint + ServingServer
        # on PADDLE_TPU_REPLICA_ENDPOINT); the router process is the
        # operator's own
        for i, ep in enumerate(e for e in args.serving_replicas.split(",")
                               if e):
            specs.append((f"replica.{i}",
                          {"PADDLE_TPU_REPLICA_ENDPOINT": ep,
                           "PADDLE_TPU_REPLICA_ID": str(i)}, script))
    else:
        if args.trainer_endpoints:
            endpoints = args.trainer_endpoints.split(",")
        else:
            n = args.nproc_per_node or 1
            ips = args.ips.split(",")
            endpoints = [f"{ip}:{args.started_port + i}"
                         for ip in ips for i in range(n)]
        my_ip = args.ips.split(",")[args.node_rank]
        n_local = args.nproc_per_node or \
            len([e for e in endpoints if e.startswith(my_ip + ":")])
        if n_local == 0:
            sys.stderr.write(
                f"[launch] no endpoints on this node ({my_ip}) — pass "
                f"--nproc_per_node or include this node's ip in "
                f"--trainer_endpoints/--ips\n")
            return 1
        base = args.node_rank * n_local
        for i in range(n_local):
            rank = base + i
            specs.append((f"trainer.{rank}",
                          get_cluster_env(rank, endpoints), script))
    if args.metrics_dir:
        os.makedirs(args.metrics_dir, exist_ok=True)
        for _name, env, _argv in specs:
            env["PADDLE_TPU_METRICS_DIR"] = args.metrics_dir
    if args.debug_dir:
        os.makedirs(args.debug_dir, exist_ok=True)
        for _name, env, _argv in specs:
            env["PADDLE_TPU_DEBUG_DIR"] = args.debug_dir
    if args.cluster_ckpt_dir:
        os.makedirs(args.cluster_ckpt_dir, exist_ok=True)
        for _name, env, _argv in specs:
            env["PADDLE_TPU_CLUSTER_CKPT_DIR"] = args.cluster_ckpt_dir
    if args.publish_dir:
        # online learning: servers PUBLISH through this store, serving
        # replicas ADOPT from it (workers/trainers don't need it)
        os.makedirs(args.publish_dir, exist_ok=True)
        for name, env, _argv in specs:
            if name.startswith(("server.", "replica.")):
                env["PADDLE_TPU_PUBLISH_DIR"] = args.publish_dir
    if args.telemetry:
        # fleet telemetry: one collector child answers the tel_* verbs;
        # every rank's agent autostarts from this env at observability
        # import and streams spans/flight/metric deltas to it. Agents
        # reconnect with backoff, so neither spawn order nor collector
        # respawns matter to serving.
        for name, env, _argv in specs:
            env["PADDLE_TPU_TELEMETRY_COLLECTOR"] = args.telemetry
            env.setdefault("PADDLE_TPU_TELEMETRY_ROLE", name)
        tel_env = {"PADDLE_TPU_TELEMETRY_COLLECTOR": ""}
        if args.tsdb_dir:
            os.makedirs(args.tsdb_dir, exist_ok=True)
            tel_env["PADDLE_TPU_TSDB_DIR"] = args.tsdb_dir
        specs.append(("telemetry", tel_env,
                      [sys.executable, "-m",
                       "paddle_tpu_torch.observability.collector",
                       "--endpoint", args.telemetry]))
    from .elastic import ElasticManager
    hb_dir = None
    if args.max_restarts > 0:
        import tempfile
        hb_dir = tempfile.mkdtemp(prefix="paddle_elastic_hb_")
        for _name, env, _argv in specs:
            env["PADDLE_ELASTIC_HEARTBEAT_DIR"] = hb_dir
    ps_mode = bool(args.servers or args.workers)
    has_standbys = any(len(m) > 1 for m in ha_members)
    snap_dir = args.ps_snapshot_dir
    if ps_mode and (args.max_restarts > 0 or has_standbys) \
            and snap_dir is None:
        # HA standbys need the WAL tier (replication ships journal
        # records), and the WAL needs a snapshot dir for its bases
        import tempfile
        snap_dir = tempfile.mkdtemp(prefix="paddle_ps_snap_")
    server_specs = {}
    if snap_dir:
        for name, env, argv in specs:
            if name.startswith(("server.", "standby.")):
                env["PADDLE_PS_SNAPSHOT_DIR"] = snap_dir
                env["PADDLE_PS_SNAPSHOT_EVERY"] = \
                    str(args.ps_snapshot_every)
                server_specs[name] = (env, argv)
    if ps_mode and args.ps_tier_warm_bytes > 0:
        # tiered embedding store: every server/
        # standby child opts its tables in under the same budget; the
        # cold store defaults under the snapshot dir
        for name, env, argv in specs:
            if name.startswith(("server.", "standby.")):
                env["PADDLE_PS_TIER_WARM_BYTES"] = \
                    str(args.ps_tier_warm_bytes)
                if args.ps_tier_store_dir:
                    env["PADDLE_PS_TIER_STORE_DIR"] = \
                        args.ps_tier_store_dir
    if args.serving_replicas and args.max_restarts > 0:
        # serving replicas respawn ALONE like PS shards: their state is
        # the engine checkpoint the child script restores from, and the
        # router redispatches around the gap
        for name, env, argv in specs:
            if name.startswith("replica."):
                server_specs[name] = (env, argv)
    if args.telemetry and args.max_restarts > 0:
        # the collector is stateless — respawn it alone; agents just
        # reconnect, serving is never in the loop
        for name, env, argv in specs:
            if name == "telemetry":
                server_specs[name] = (env, argv)
    manager = ElasticManager(
        max_restarts=args.max_restarts,
        heartbeat_timeout=args.heartbeat_timeout,
        heartbeat_dir=hb_dir,
        # the telemetry collector never writes heartbeat files — it
        # must not count toward the expected rank set
        world_size=sum(1 for n, _, _ in specs if n != "telemetry"),
        step_deadline=args.step_deadline,
        straggler_lag=args.straggler_lag) \
        if args.max_restarts > 0 else None

    # the launcher's own temporary directories go with it
    own_dirs = [d for d in (hb_dir, None if args.ps_snapshot_dir
                            else snap_dir) if d]
    try:
        fail_times: list[float] = []     # monotonic stamps of job failures
        offender_counts: dict[str, int] = {}
        server_specs0 = dict(server_specs)  # pristine roles per attempt
        while True:
            if hb_dir:  # fresh heartbeat epoch per attempt
                for f in os.listdir(hb_dir):
                    os.unlink(os.path.join(hb_dir, f))
            # whole-job (re)start resets HA roles: member 0 is primary at
            # epoch 1 again (the snapshot dir is cleared below, so there
            # is no prior shard state for a stale epoch to fence)
            server_specs = dict(server_specs0)
            ha_state, name_shard = _build_ha_state(ha_members)
            if snap_dir and os.path.isdir(snap_dir):
                # whole-job (re)start: workers replay from scratch with
                # fresh request ids, so a server resuming mid-run tables
                # from a stale snapshot would double-apply every first-life
                # push — servers must start fresh too. (Single-server
                # respawn inside _watch intentionally KEEPS the snapshot:
                # there the workers' in-flight state continues. The
                # cluster-checkpoint dir is likewise never cleared — it is
                # the state restarts resume from.)
                for f in os.listdir(snap_dir):
                    path = os.path.join(snap_dir, f)
                    if os.path.isdir(path):  # a tier store
                        shutil.rmtree(path, ignore_errors=True)
                    else:
                        os.unlink(path)
            procs = _spawn_children(specs, args.log_dir)
            # forward SIGTERM to the job
            signal.signal(signal.SIGTERM, lambda *a: (_kill_all(procs),
                                                      sys.exit(143)))
            rc, needs_restart, offender, reason = _watch(
                procs, manager, specs=server_specs, log_dir=args.log_dir,
                rank_names=_heartbeat_rank_names(specs),
                ha_state=ha_state, name_shard=name_shard)
            if rc == 0 or manager is None or not needs_restart:
                return rc
            if offender is not None:
                offender_counts[offender] = \
                    offender_counts.get(offender, 0) + 1
            now = time.monotonic()
            fail_times.append(now)
            recent = [t for t in fail_times
                      if now - t <= args.crash_loop_window]
            flapping = max(offender_counts, key=offender_counts.get) \
                if offender_counts else None
            if args.crash_loop_threshold \
                    and len(recent) >= args.crash_loop_threshold:
                # crash loop: restarting is burning the budget without
                # progress — stop, leave a postmortem naming the repeat
                # offender
                sys.stderr.write(
                    f"[launch] crash loop: {len(recent)} failures within "
                    f"{args.crash_loop_window:g}s (flapping: {flapping}); "
                    f"giving up\n")
                manager.record_giveup("crash_loop", flapping)
                _write_giveup_bundle(args, "crash_loop", flapping,
                                     offender_counts, manager, rc)
                return rc or 1
            if not manager.should_restart():
                manager.record_giveup("restarts_exhausted", flapping)
                _write_giveup_bundle(args, "restarts_exhausted", flapping,
                                     offender_counts, manager, rc)
                return rc
            manager.record_restart(reason or "crash")
            sys.stderr.write(
                f"[launch] elastic restart "
                f"{manager.restart_count}/{manager.max_restarts}\n")
            if args.exclude_flapping and offender is not None \
                    and offender_counts.get(offender, 0) \
                    >= args.flap_threshold:
                shrunk = _drop_trainer_rank(specs, offender)
                if shrunk is not None:
                    specs = shrunk
                    manager.world_size = sum(
                        1 for n, _, _ in specs if n != "telemetry")
                    # identities renumbered — restart the flap accounting
                    offender_counts.clear()
                    sys.stderr.write(
                        f"[launch] excluding flapping rank {offender} "
                        f"(failed {args.flap_threshold}+ times); "
                        f"respawning at world {manager.world_size} — "
                        f"children resume via the cluster-checkpoint "
                        f"resize path\n")
            delay = 0.0
            if args.restart_backoff > 0:
                delay = min(
                    args.restart_backoff * 2 ** (manager.restart_count - 1),
                    args.restart_backoff_max)
                sys.stderr.write(
                    f"[launch] backing off {delay:.1f}s before restart\n")
                time.sleep(delay)
            manager.reset_epoch()

    finally:
        for d in own_dirs:
            shutil.rmtree(d, ignore_errors=True)

def _heartbeat_rank_names(specs):
    """Heartbeat rank → child name (ranks come from the child's
    PADDLE_TRAINER_ID, which is what start_heartbeat writes)."""
    names = {}
    for name, env, _argv in specs:
        if name == "telemetry":
            continue
        try:
            names[int(env.get("PADDLE_TRAINER_ID", "-1"))] = name
        except ValueError:
            pass
    return names


def _drop_trainer_rank(specs, offender):
    """Rebuild collective-trainer specs at world W-1 without
    ``offender`` (a ``trainer.N`` child name): survivors renumber to
    ranks 0..W-2 and the endpoint list shrinks, so the respawned gang
    forms a valid smaller collective and resumes through
    cluster_ckpt's resize restore. Returns None when not applicable
    (PS/serving modes, unknown name, or nothing would survive)."""
    if not offender.startswith("trainer."):
        return None
    trainers = [(n, e, a) for n, e, a in specs
                if n.startswith("trainer.")]
    others = [s for s in specs if not s[0].startswith("trainer.")]
    keep = sorted((t for t in trainers if t[0] != offender),
                  key=lambda t: int(t[0].split(".", 1)[1]))
    if not keep or len(keep) == len(trainers):
        return None
    endpoints = [t[1]["PADDLE_CURRENT_ENDPOINT"] for t in keep]
    new = []
    for new_rank, (_old, env, argv) in enumerate(keep):
        env = dict(env)
        env.update({
            "PADDLE_TRAINER_ID": str(new_rank),
            "PADDLE_TRAINERS_NUM": str(len(endpoints)),
            "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
            "PADDLE_COORDINATOR": endpoints[0],
        })
        new.append((f"trainer.{new_rank}", env, argv))
    return new + others


def _write_giveup_bundle(args, reason, flapping, offender_counts,
                         manager, rc):
    """Postmortem for an abandoned job: a debug bundle whose manifest
    reason names the flapping rank (best-effort — only when
    a debug dir is configured)."""
    dir_ = args.debug_dir or os.environ.get("PADDLE_TPU_DEBUG_DIR")
    if not dir_:
        return
    try:
        from ..observability import debug as _debug
        tag = f"{reason}:{flapping}" if flapping else reason
        path = _debug.write_bundle(
            dir_, reason=tag,
            extra={"flapping": flapping,
                   "offender_counts": dict(offender_counts),
                   "restarts": manager.restart_count,
                   "exit_code": rc})
        sys.stderr.write(f"[launch] wrote debug bundle {path}\n")
    except Exception as e:  # never mask the real exit path
        sys.stderr.write(f"[launch] debug bundle failed: {e}\n")


def main():
    sys.exit(launch())


if __name__ == "__main__":
    main()

"""The port's launcher (paddle_tpu_torch/distributed/launch.py and
fleet/launch.py) on the CPU, held to the JAX package's: the cases of
tests/test_launcher.py and tests/test_elastic.py through
``python -m paddle_tpu_torch.distributed.launch`` (two gloo ranks that
join one group and run collectives, teardown on a crash, fleetrun's PS
roles, restarts with backoff, the crash-loop give-up and its bundle, a
rank whose heartbeat stops, ``--metrics_dir``), the parser and helpers
against the reference's, the env that ``--telemetry`` / ``--tsdb-dir`` /
``--publish_dir`` hand the children, and the offender of a gang that
fell together.

The metrics case checks each child's own dump (``aggregate_dir`` and the
registry CLI's trace merge are tests/test_torch_telemetry.py's).
"""
import json
import os
import socket
import subprocess
import sys
import time

import pytest

from paddle_tpu.distributed import launch as jlaunch
from paddle_tpu_torch.distributed import launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch"]


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for k in list(env):
        if k.startswith("PADDLE_PS_FAULT_"):
            env.pop(k)
    env.update(extra)
    return env


def _logs(d):
    return "".join(f"--- {f} ---\n" + open(os.path.join(d, f)).read()
                   for f in sorted(os.listdir(d)))


# ---------------------------------------------------------------------------
# the parser and helpers against the reference's
# ---------------------------------------------------------------------------

def _options(parse):
    import argparse
    captured = {}
    real = argparse.ArgumentParser.parse_args

    def grab(self, argv=None, namespace=None):
        captured["p"] = self
        return real(self, argv, namespace)

    argparse.ArgumentParser.parse_args = grab
    try:
        parse(["x.py"])
    finally:
        argparse.ArgumentParser.parse_args = real
    return {a.dest: (tuple(a.option_strings), a.default, a.nargs, a.const)
            for a in captured["p"]._actions if a.dest != "help"}


def test_parser_has_every_reference_flag_and_default():
    """No flag of the reference's launcher is missing or changed: the
    unported ones parse too, and raise in launch()."""
    assert _options(launch._parse) == _options(jlaunch._parse)


def test_cluster_env_is_the_launchers_and_the_references():
    from paddle_tpu_torch.distributed.spawn import get_cluster_env
    assert get_cluster_env is launch.get_cluster_env
    eps = ["127.0.0.1:7001", "127.0.0.1:7002", "127.0.0.1:7003"]
    for r in range(3):
        assert launch.get_cluster_env(r, eps) == \
            jlaunch.get_cluster_env(r, eps)
    assert launch.get_cluster_env(1, eps, "PSERVER", "a:1", "b:2") == \
        jlaunch.get_cluster_env(1, eps, "PSERVER", "a:1", "b:2")


def _trainer_specs(n):
    eps = [f"127.0.0.1:{7000 + i}" for i in range(n)]
    return [(f"trainer.{r}", launch.get_cluster_env(r, eps), ["x"])
            for r in range(n)] + [("server.0", {"PADDLE_SERVER_ID": "0"},
                                   ["x"])]


@pytest.mark.parametrize("offender", ["trainer.0", "trainer.2",
                                      "trainer.3", "server.0", "nobody"])
def test_drop_trainer_rank_matches_the_reference(offender):
    got = launch._drop_trainer_rank(_trainer_specs(4), offender)
    assert got == jlaunch._drop_trainer_rank(_trainer_specs(4), offender)
    if offender.startswith("trainer."):
        assert [n for n, _, _ in got] == ["trainer.0", "trainer.1",
                                          "trainer.2", "server.0"]
        assert {e["PADDLE_TRAINERS_NUM"] for _, e, _ in got[:3]} == {"3"}


def test_ha_state_and_rank_names_match_the_reference():
    groups = [["a:1", "a:2", "a:3"], ["b:1"], ["c:1", "c:2"]]
    assert launch._build_ha_state(groups) == \
        jlaunch._build_ha_state(groups)
    specs = _trainer_specs(3)
    assert launch._heartbeat_rank_names(specs) == \
        jlaunch._heartbeat_rank_names(specs)


@pytest.mark.parametrize("flag,item", [
    # bare --telemetry before another flag (else it takes the script)
    (["--telemetry", "--log_dir", "logs"], "18"),
    (["--telemetry", "127.0.0.1:9"], "18"),
    (["--tsdb-dir", "tsdb"], "18"), (["--publish_dir", "pub"], "17")])
def test_unported_flags_raise_before_any_child(tmp_path, monkeypatch,
                                               flag, item):
    """The flags this test once saw raise (ROADMAP.md A items 17 and
    18) are ported: launch() no longer raises and hands each child the
    reference's env — --telemetry points every child's agent at a
    `telemetry` child running the port's collector (bare: the default
    127.0.0.1:8600), --tsdb-dir alone changes nothing (it needs
    --telemetry), --publish_dir reaches PS server and replica children
    only. The children are captured, not started."""
    import types
    got = {}

    def spawn(specs, log_dir):
        got["specs"] = [(n, dict(e), list(a)) for n, e, a in specs]
        return []

    monkeypatch.setattr(launch, "_spawn_children", spawn)
    monkeypatch.setattr(launch, "_watch",
                        lambda *a, **k: (0, False, None, None))
    monkeypatch.setattr(launch, "signal", types.SimpleNamespace(
        signal=lambda *a: None, SIGTERM=15))
    monkeypatch.chdir(tmp_path)
    assert launch.launch(["--nproc_per_node=1", *flag, "w.py"]) == 0
    specs = {n: (e, a) for n, e, a in got["specs"]}
    if "--telemetry" in flag:
        ep = "127.0.0.1:8600" if flag[1].startswith("--") else flag[1]
        assert set(specs) == {"trainer.0", "telemetry"}
        env, argv = specs["telemetry"]
        assert argv[1:] == ["-m", "paddle_tpu_torch.observability.collector",
                            "--endpoint", ep]
        assert env == {"PADDLE_TPU_TELEMETRY_COLLECTOR": ""}
        tenv = specs["trainer.0"][0]
        assert tenv["PADDLE_TPU_TELEMETRY_COLLECTOR"] == ep
        assert tenv["PADDLE_TPU_TELEMETRY_ROLE"] == "trainer.0"
    else:
        assert set(specs) == {"trainer.0"}
        env = specs["trainer.0"][0]
        assert "PADDLE_TPU_TELEMETRY_COLLECTOR" not in env
        assert "PADDLE_TPU_TSDB_DIR" not in env
        # a trainer never publishes: the dir is made, not handed over
        assert "PADDLE_TPU_PUBLISH_DIR" not in env
        if item == "17":
            assert (tmp_path / "pub").is_dir()


# ---------------------------------------------------------------------------
# tests/test_launcher.py
# ---------------------------------------------------------------------------

_DIST_WORKER = """
import os
import numpy as np
import torch
from paddle_tpu_torch.distributed import env
from paddle_tpu_torch.distributed import collective as C

torch.set_num_threads(1)
penv = env.init_parallel_env()
assert penv.world_size == 2 and penv.backend == "gloo", penv.backend
rank = penv.rank
assert rank == int(os.environ["PADDLE_TRAINER_ID"])
t = C.all_reduce(torch.tensor([float(rank + 1), 2.0]))
assert t.tolist() == [3.0, 4.0], t
b = C.broadcast(torch.tensor([float(rank * 10)]), src=1)
assert float(b[0]) == 10.0
parts = []
C.all_gather(parts, torch.tensor([float(rank)]))
assert sorted(float(p[0]) for p in parts) == [0.0, 1.0]
rd = C.reduce(torch.tensor([float(rank + 1)]), dst=0)
if rank == 0:
    assert float(rd[0]) == 3.0
C.barrier()
print(f"worker {rank} OK", flush=True)
import torch.distributed as dist
dist.destroy_process_group()
"""


def test_launch_two_process_collectives(tmp_path):
    """--nproc_per_node=2: the children join one gloo group at
    tcp://PADDLE_COORDINATOR and run all_reduce / broadcast /
    all_gather / reduce / barrier across two processes."""
    script = tmp_path / "dist_worker.py"
    script.write_text(_DIST_WORKER)
    logs = tmp_path / "logs"
    res = subprocess.run(
        LAUNCH + ["--nproc_per_node=2", f"--started_port={_free_port()}",
                  "--log_dir", str(logs), str(script)],
        env=_env(), capture_output=True, text=True, timeout=120)
    text = _logs(logs)
    assert res.returncode == 0, f"{res.stderr}\n{text}"
    assert "worker 0 OK" in text and "worker 1 OK" in text, text


def test_launch_kills_job_on_child_failure(tmp_path):
    bad = tmp_path / "bad_worker.py"
    bad.write_text(
        "import os, sys, time\n"
        "if os.environ['PADDLE_TRAINER_ID'] == '1':\n"
        "    sys.exit(3)\n"
        "time.sleep(60)\n")
    t0 = time.monotonic()
    res = subprocess.run(
        LAUNCH + ["--nproc_per_node=2", f"--started_port={_free_port()}",
                  str(bad)],
        env=_env(), capture_output=True, text=True, timeout=60)
    assert res.returncode == 3
    assert "trainer.1 exited with code 3; terminating the job" \
        in res.stderr
    assert time.monotonic() - t0 < 30


def test_fleetrun_ps_mode_env(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text(
        "import os\n"
        "role = os.environ['TRAINING_ROLE']\n"
        "print(role, os.environ.get('PADDLE_SERVER_ID', ''),\n"
        "      os.environ['PADDLE_TRAINER_ID'],\n"
        "      os.environ['PADDLE_CURRENT_ENDPOINT'], flush=True)\n")
    p1, p2, p3 = _free_port(), _free_port(), _free_port()
    logd = tmp_path / "logs"
    res = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.fleet.launch",
         f"--servers=127.0.0.1:{p1}",
         f"--workers=127.0.0.1:{p2},127.0.0.1:{p3}",
         "--log_dir", str(logd), str(probe)],
        env=_env(), capture_output=True, text=True, timeout=60,
        cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr
    logs = {f: open(logd / f).read() for f in os.listdir(logd)}
    assert f"PSERVER 0 0 127.0.0.1:{p1}" in logs["server.0.log"]
    assert f"TRAINER  1 127.0.0.1:{p3}" in logs["worker.1.log"]
    workers = [v for k, v in logs.items() if k.startswith("worker.")]
    assert len(workers) == 2 and all("TRAINER" in w for w in workers)


def test_launch_metrics_dir_collects_per_process_dumps(tmp_path):
    """--metrics_dir: every child dumps its registry at exit, one
    metrics_<host>_<pid>.json each, with its own counts."""
    worker = tmp_path / "worker.py"
    worker.write_text(
        "from paddle_tpu_torch import observability as obs\n"
        "c = obs.counter('paddle_tpu_launchtest_units_total', 'u')\n"
        "c.inc(2)\n"
        "print('worker done', flush=True)\n")
    mdir = tmp_path / "metrics"
    res = subprocess.run(
        LAUNCH + ["--nproc_per_node=2", f"--started_port={_free_port()}",
                  "--metrics_dir", str(mdir),
                  "--log_dir", str(tmp_path / "logs"), str(worker)],
        env=_env(), capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    dumps = sorted(f for f in os.listdir(mdir)
                   if f.startswith("metrics_") and f.endswith(".json"))
    assert len(dumps) == 2, dumps
    for f in dumps:
        rec = {m["name"]: m for m in json.load(open(mdir / f))["metrics"]}
        assert rec["paddle_tpu_launchtest_units_total"]["samples"][0][
            "value"] == 2


def test_launch_exponential_backoff_between_restarts(tmp_path):
    bad = tmp_path / "always_fail.py"
    bad.write_text("import sys; sys.exit(7)\n")
    t0 = time.monotonic()
    res = subprocess.run(
        LAUNCH + ["--nproc_per_node=1", f"--started_port={_free_port()}",
                  "--max_restarts=3", "--restart_backoff=0.5",
                  "--restart_backoff_max=1.0", str(bad)],
        env=_env(), capture_output=True, text=True, timeout=120)
    wall = time.monotonic() - t0
    assert res.returncode == 7
    assert res.stderr.count("elastic restart") == 3, res.stderr
    delays = [float(line.rsplit(" ", 3)[1].rstrip("s"))
              for line in res.stderr.splitlines() if "backing off" in line]
    assert delays == [0.5, 1.0, 1.0], res.stderr   # doubled, then capped
    assert wall >= 2.5, wall


def test_launch_crash_loop_gives_up_with_debug_bundle(tmp_path):
    bad = tmp_path / "always_fail.py"
    bad.write_text(
        "import os, sys, time\n"
        "if os.environ['PADDLE_TRAINER_ID'] == '0':\n"
        "    sys.exit(9)\n"
        "time.sleep(60)\n")
    dbg = tmp_path / "debug"
    res = subprocess.run(
        LAUNCH + ["--nproc_per_node=2", f"--started_port={_free_port()}",
                  "--max_restarts=10", "--restart_backoff=0.05",
                  "--crash_loop_window=60", "--crash_loop_threshold=3",
                  "--debug_dir", str(dbg), str(bad)],
        env=_env(), capture_output=True, text=True, timeout=120)
    assert res.returncode == 9
    assert "crash loop: 3 failures" in res.stderr, res.stderr
    assert "trainer.0" in res.stderr
    assert res.stderr.count("elastic restart") == 2, res.stderr
    bundles = [d for d in os.listdir(dbg)
               if (dbg / d / "MANIFEST.json").exists()]
    assert len(bundles) == 1, os.listdir(dbg)
    man = json.load(open(dbg / bundles[0] / "MANIFEST.json"))
    assert "crash_loop" in man["reason"] and "trainer.0" in man["reason"]
    extra = json.load(open(dbg / bundles[0] / "extra.json"))
    assert extra["flapping"] == "trainer.0"
    assert extra["offender_counts"]["trainer.0"] == 3
    from paddle_tpu.observability.debug import load_bundle
    load_bundle(str(dbg / bundles[0]), verify=True)  # the reference reads it


def test_offender_is_the_rank_that_died_first(tmp_path):
    """Rank 1 dies; rank 0 dies of it 20 ms later, inside one watch poll
    (with real collectives a peer's collective fails right after). The
    give-up names rank 1, not the first child of the list."""
    gone = tmp_path / "rank1_gone"
    bad = tmp_path / "gang.py"
    bad.write_text(
        "import os, sys, time\n"
        f"gone = {str(gone)!r}\n"
        "if os.environ['PADDLE_TRAINER_ID'] == '1':\n"
        "    time.sleep(0.5)\n"
        "    open(gone, 'w').close()\n"
        "    os._exit(5)\n"
        "while not os.path.exists(gone):\n"
        "    time.sleep(0.002)\n"
        "time.sleep(0.02)\n"
        "sys.exit(6)\n")
    res = subprocess.run(
        LAUNCH + ["--nproc_per_node=2", f"--started_port={_free_port()}",
                  "--max_restarts=3", "--crash_loop_threshold=1",
                  str(bad)],
        env=_env(), capture_output=True, text=True, timeout=60)
    assert res.returncode == 5, res.stderr
    assert "trainer.1 exited with code 5" in res.stderr, res.stderr
    assert "flapping: trainer.1" in res.stderr, res.stderr


# ---------------------------------------------------------------------------
# tests/test_elastic.py
# ---------------------------------------------------------------------------

def test_launcher_restarts_crashed_job(tmp_path):
    marker = tmp_path / "crashed_once"
    script = tmp_path / "worker.py"
    script.write_text(
        "import os, sys\n"
        f"marker = {str(marker)!r}\n"
        "if not os.path.exists(marker):\n"
        "    open(marker, 'w').close()\n"
        "    sys.exit(7)\n"
        "print('recovered OK', flush=True)\n")
    res = subprocess.run(
        LAUNCH + ["--nproc_per_node=1", "--started_port=0",
                  "--max_restarts=2", "--log_dir", str(tmp_path / "logs"),
                  str(script)],
        env=_env(), capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "elastic restart 1/2" in res.stderr
    assert "recovered OK" in _logs(tmp_path / "logs")


def test_launcher_gives_up_after_max_restarts(tmp_path):
    script = tmp_path / "always_fails.py"
    script.write_text("import sys; sys.exit(9)\n")
    res = subprocess.run(
        LAUNCH + ["--nproc_per_node=1", "--started_port=0",
                  "--max_restarts=1", "--restart_backoff=0.05",
                  str(script)],
        env=_env(), capture_output=True, text=True, timeout=120)
    assert res.returncode == 9
    assert res.stderr.count("elastic restart") == 1


def test_launcher_kills_hung_rank_via_heartbeat(tmp_path):
    """A rank that starts the port's heartbeat then stops it (hangs) is
    detected and the job restarted; its second life completes."""
    marker = tmp_path / "hung_once"
    script = tmp_path / "hang.py"
    script.write_text(
        "import os, sys, time\n"
        "from paddle_tpu_torch.distributed.elastic import start_heartbeat\n"
        f"marker = {str(marker)!r}\n"
        "hb = start_heartbeat(interval=0.2)\n"
        "if not os.path.exists(marker):\n"
        "    open(marker, 'w').close()\n"
        "    hb.stop()\n"
        "    time.sleep(120)\n"
        "print('second life OK', flush=True)\n")
    res = subprocess.run(
        LAUNCH + ["--nproc_per_node=1", "--started_port=0",
                  "--max_restarts=1", "--restart_backoff=0.05",
                  "--heartbeat_timeout=2", "--log_dir",
                  str(tmp_path / "logs"), str(script)],
        env=_env(), capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, (res.stderr, res.stdout)
    assert "ranks [0] missed heartbeats" in res.stderr
    assert "second life OK" in _logs(tmp_path / "logs")

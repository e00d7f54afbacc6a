"""The port's launcher restarting one child alone, on the CPU: the
cases of tests/test_elastic.py, tests/test_launcher.py and
tests/test_router.py:829 through ``python -m
paddle_tpu_torch.distributed.launch`` with the port's PS shards and
serving replicas:

  * a PS server that dies mid-run restarts alone from its snapshot (no
    whole-job restart), and one killed inside pushes in flight from two
    workers x three threads lands every push exactly once;
  * a serving replica killed at a request restarts alone from its
    engine checkpoint (tests/torch_serving_replica.py, the port's tiny
    GPT) and serves again on its endpoint;
  * an HA shard (``--servers primary|standby``) whose primary dies has
    its standby promoted by the launcher (``ps_ha.promote_best``, epoch
    2) and the dead member respawned as a standby of it, while a worker's
    pushes land exactly once.
"""
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch"]
PS = "paddle_tpu_torch.distributed.fleet.runtime.parameter_server_runtime"


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
    env["PADDLE_TPU_DISABLE_NATIVE"] = "1"
    env.update(extra)
    return env


def _logs(d):
    return "".join(f"--- {f} ---\n" + open(os.path.join(d, f)).read()
                   for f in sorted(os.listdir(d)))


def test_launcher_respawns_dead_ps_server_alone(tmp_path):
    script = tmp_path / "ps_job.py"
    script.write_text(
        "import os, sys\n"
        "import numpy as np\n"
        "role = os.environ['TRAINING_ROLE']\n"
        "if role == 'PSERVER':\n"
        "    snap = os.environ['PADDLE_PS_SNAPSHOT_DIR']\n"
        "    if not os.path.exists(snap) or not os.listdir(snap):\n"
        "        # first life: arm the kill switch; the respawned life\n"
        "        # finds a snapshot and serves normally\n"
        "        os.environ['PADDLE_PS_FAULT_KILL_AFTER'] = '25'\n"
        "        os.environ['PADDLE_PS_FAULT_KILL_POINT'] = 'reply'\n"
        f"    from {PS} import PSServer\n"
        "    PSServer(os.environ['PADDLE_CURRENT_ENDPOINT'])"
        ".serve_forever()\n"
        "else:\n"
        f"    from {PS} import PSClient\n"
        "    eps = os.environ['PADDLE_PSERVERS_IP_PORT_LIST'].split(',')\n"
        "    cl = PSClient(eps, backoff=0.02, deadline=120.0)\n"
        "    base = cl.pull('t', 4, [0]).copy()\n"
        "    for k in range(60):\n"
        "        cl.push('t', 4, [0], np.ones((1, 4)), lr=1.0)\n"
        "    final = cl.pull('t', 4, [0])\n"
        "    np.testing.assert_allclose(base - final, 60.0, rtol=1e-6)\n"
        "    assert cl.stats.retries > 0, cl.stats.as_dict()\n"
        "    print('PS WORKER OK', flush=True)\n")
    res = subprocess.run(
        LAUNCH + [f"--servers=127.0.0.1:{_free_port()}",
                  f"--workers=127.0.0.1:{_free_port()}",
                  "--max_restarts=2",
                  "--ps_snapshot_dir", str(tmp_path / "snap"),
                  "--ps_snapshot_every=1",
                  "--log_dir", str(tmp_path / "logs"), str(script)],
        env=_env(PADDLE_PS_SNAPSHOT_EVERY="1"), capture_output=True,
        text=True, timeout=120)
    assert res.returncode == 0, (res.stderr, _logs(tmp_path / "logs"))
    assert "restarting it from snapshot" in res.stderr, res.stderr
    assert "elastic restart" not in res.stderr  # no whole-job restart
    assert "all workers finished" in res.stderr
    assert "PS WORKER OK" in _logs(tmp_path / "logs")


def test_launcher_respawns_ps_killed_mid_push_under_load(tmp_path):
    """The shard dies at kill point `reply` (committed, unacknowledged)
    while two workers x three client threads keep pushes in flight; it
    restarts alone from its write-through snapshot and retry + dedup
    land every push exactly once. The workers meet at a file barrier
    before their pushes, so that on a loaded host the kill still lands
    inside both workers' flights."""
    sync = tmp_path / "sync"
    sync.mkdir()
    script = tmp_path / "midpush_job.py"
    script.write_text(
        "import os, threading, time\n"
        "import numpy as np\n"
        "role = os.environ['TRAINING_ROLE']\n"
        "if role == 'PSERVER':\n"
        "    snap = os.environ['PADDLE_PS_SNAPSHOT_DIR']\n"
        "    if not os.path.exists(snap) or not os.listdir(snap):\n"
        "        os.environ['PADDLE_PS_FAULT_KILL_AFTER'] = '25'\n"
        "        os.environ['PADDLE_PS_FAULT_KILL_POINT'] = 'reply'\n"
        f"    from {PS} import PSServer\n"
        "    PSServer(os.environ['PADDLE_CURRENT_ENDPOINT'])"
        ".serve_forever()\n"
        "else:\n"
        f"    from {PS} import PSClient\n"
        "    eps = os.environ['PADDLE_PSERVERS_IP_PORT_LIST'].split(',')\n"
        "    rank = int(os.environ['PADDLE_TRAINER_ID'])\n"
        "    T, N = 3, 15\n"
        "    cl0 = PSClient(eps, backoff=0.02, deadline=120.0)\n"
        "    base = cl0.pull('t', 4, [rank]).copy()\n"
        "    clients = [PSClient(eps, backoff=0.02, deadline=120.0)\n"
        "               for _ in range(T)]\n"
        f"    sync = {str(sync)!r}\n"
        "    open(os.path.join(sync, f'ready{rank}'), 'w').close()\n"
        "    while len(os.listdir(sync)) < 2:\n"
        "        time.sleep(0.005)\n"
        "    start = threading.Barrier(T)\n"
        "    errs = []\n"
        "    def run(cl):\n"
        "        try:\n"
        "            start.wait()\n"
        "            for _ in range(N):\n"
        "                cl.push('t', 4, [rank], np.ones((1, 4)),"
        " lr=1.0)\n"
        "        except Exception as e:\n"
        "            errs.append(e)\n"
        "    ths = [threading.Thread(target=run, args=(cl,))\n"
        "           for cl in clients]\n"
        "    for th in ths: th.start()\n"
        "    for th in ths: th.join()\n"
        "    assert not errs, errs\n"
        "    final = cl0.pull('t', 4, [rank])\n"
        "    np.testing.assert_allclose(base - final, float(T * N),\n"
        "                               rtol=1e-6)\n"
        "    assert sum(c.stats.retries for c in clients) > 0\n"
        "    print(f'MIDPUSH WORKER {rank} OK', flush=True)\n")
    res = subprocess.run(
        LAUNCH + [f"--servers=127.0.0.1:{_free_port()}",
                  f"--workers=127.0.0.1:{_free_port()},"
                  f"127.0.0.1:{_free_port()}",
                  "--max_restarts=2",
                  "--ps_snapshot_dir", str(tmp_path / "snap"),
                  "--ps_snapshot_every=1",
                  "--log_dir", str(tmp_path / "logs"), str(script)],
        env=_env(), capture_output=True, text=True, timeout=120)
    logs = _logs(tmp_path / "logs")
    assert res.returncode == 0, (res.stderr, logs)
    assert "restarting it from snapshot" in res.stderr, res.stderr
    assert "elastic restart" not in res.stderr
    assert "MIDPUSH WORKER 0 OK" in logs and "MIDPUSH WORKER 1 OK" in logs


def test_launcher_promotes_ha_standby_and_respawns_primary(tmp_path):
    """--servers 'P|S': the launcher starts the primary at epoch 1 and S
    as its standby (WAL on). The primary dies after 40 requests; the
    launcher promotes S (epoch 2) and respawns the dead member as a
    standby of S; the worker's 60 pushes land exactly once."""
    marker = tmp_path / "primary_killed"
    script = tmp_path / "ha_job.py"
    script.write_text(
        "import os, time\n"
        "import numpy as np\n"
        "role = os.environ['TRAINING_ROLE']\n"
        f"marker = {str(marker)!r}\n"
        "if role == 'PSERVER':\n"
        "    if not os.environ.get('PADDLE_PS_HA_PRIMARY') \\\n"
        "            and not os.path.exists(marker):\n"
        "        open(marker, 'w').close()\n"
        "        os.environ['PADDLE_PS_FAULT_KILL_AFTER'] = '40'\n"
        "        os.environ['PADDLE_PS_FAULT_KILL_POINT'] = 'reply'\n"
        f"    from {PS} import PSServer\n"
        "    PSServer(os.environ['PADDLE_CURRENT_ENDPOINT'])"
        ".serve_forever()\n"
        "else:\n"
        f"    from {PS} import PSClient\n"
        "    eps = os.environ['PADDLE_PSERVERS_IP_PORT_LIST'].split(',')\n"
        "    cl = PSClient(eps, backoff=0.02, deadline=120.0)\n"
        "    base = cl.pull('t', 4, [0]).copy()\n"
        "    time.sleep(1.0)      # the standby attaches\n"
        "    for k in range(60):\n"
        "        cl.push('t', 4, [0], np.ones((1, 4)), lr=1.0)\n"
        "    final = cl.pull('t', 4, [0])\n"
        "    np.testing.assert_allclose(base - final, 60.0, rtol=1e-6)\n"
        "    assert cl.failovers >= 1, cl.failovers\n"
        "    print('HA WORKER OK', flush=True)\n")
    prim, stby = f"127.0.0.1:{_free_port()}", f"127.0.0.1:{_free_port()}"
    res = subprocess.run(
        LAUNCH + [f"--servers={prim}|{stby}",
                  f"--workers=127.0.0.1:{_free_port()}",
                  "--max_restarts=1",
                  "--log_dir", str(tmp_path / "logs"), str(script)],
        env=_env(PADDLE_PS_HA_SEMISYNC="1",
                 PADDLE_PS_HA_SEMISYNC_TIMEOUT="10.0"),
        capture_output=True, text=True, timeout=150)
    logs = _logs(tmp_path / "logs")
    assert res.returncode == 0, (res.stderr, logs)
    assert marker.exists()
    assert f"promoting standby {stby} (epoch 2)" in res.stderr, res.stderr
    assert f"respawning it as a standby of {stby}" in res.stderr
    assert "elastic restart" not in res.stderr
    assert "HA WORKER OK" in logs


ENGINE_KW = dict(num_slots=4, num_pages=64, page_size=4, max_seq_len=48)


@pytest.fixture(scope="module")
def ckpt_root(tmp_path_factory):
    from paddle_tpu_torch.models.gpt import GPTConfig
    from paddle_tpu_torch.serving import GPTDecodeModel
    root = str(tmp_path_factory.mktemp("fleet") / "gpt")
    GPTDecodeModel(GPTConfig.tiny(num_layers=1), seed=0,
                   device="cpu").save_checkpoint(root)
    return root


def test_launch_respawns_replica_alone_subprocess(ckpt_root, tmp_path):
    """--serving_replicas: a replica that dies at a request (kill knob)
    restarts alone from its engine checkpoint under --max_restarts and
    serves again on the same endpoint."""
    from paddle_tpu_torch.distributed.fleet.runtime.rpc import RpcClient
    port = _free_port()
    arm = str(tmp_path / "arm_kill")
    env = _env(REPLICA_CKPT=ckpt_root,
               REPLICA_ENGINE_KW=json.dumps(ENGINE_KW),
               REPLICA_ARM_FAULT_FILE=arm,
               PADDLE_PS_FAULT_KILL_AFTER="1",
               PADDLE_PS_FAULT_KILL_POINT="recv")
    launcher = subprocess.Popen(
        LAUNCH + ["--serving_replicas", f"127.0.0.1:{port}",
                  "--max_restarts", "1",
                  os.path.join(REPO, "tests", "torch_serving_replica.py")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def try_generate() -> bool:
        rc = RpcClient(f"127.0.0.1:{port}", timeout=10, deadline=10,
                       max_retries=0)
        try:
            rep = rc.call({"op": "generate",
                           "prompt": np.asarray([1, 2], np.int32),
                           "max_new_tokens": 3, "timeout": 10},
                          timeout=10, deadline=10)
            return rep.get("status") == "done"
        except Exception:
            return False
        finally:
            rc.close()

    def wait_serving(what):
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if try_generate():
                return
            time.sleep(0.25)
        raise AssertionError(what)

    stderr = ""
    try:
        wait_serving("replica never came up")
        open(arm, "w").close()
        time.sleep(0.3)                      # the child polls the file
        try_generate()                       # burns the kill (dies@recv)
        os.unlink(arm)                       # the respawn must not re-arm
        wait_serving("respawned replica never served")
    finally:
        launcher.terminate()
        try:
            _, stderr = launcher.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            launcher.kill()
            _, stderr = launcher.communicate(timeout=30)
    assert "replica.0 exited with code 23; restarting it alone from its " \
        "engine checkpoint (1/1)" in stderr, stderr
    assert "elastic restart" not in stderr


def test_whole_job_restart_clears_a_tiered_snapshot_dir(tmp_path):
    """--ps_tier_warm_bytes puts the shards' cold store under the
    snapshot dir (``<snap>/tier_store``). A whole-job restart clears the
    snapshot dir, the cold store's directory with it, and the second
    life trains from fresh tables."""
    marker = tmp_path / "worker_failed_once"
    script = tmp_path / "tier_job.py"
    script.write_text(
        "import os, sys, time\n"
        "import numpy as np\n"
        "role = os.environ['TRAINING_ROLE']\n"
        f"marker = {str(marker)!r}\n"
        "if role == 'PSERVER':\n"
        f"    from {PS} import PSServer\n"
        "    PSServer(os.environ['PADDLE_CURRENT_ENDPOINT'])"
        ".serve_forever()\n"
        "else:\n"
        f"    from {PS} import PSClient\n"
        "    eps = os.environ['PADDLE_PSERVERS_IP_PORT_LIST'].split(',')\n"
        "    cl = PSClient(eps, backoff=0.02, deadline=60.0)\n"
        "    base = cl.pull('t', 4, np.arange(64)).copy()\n"
        "    cl.push('t', 4, np.arange(64), np.ones((64, 4)), lr=1.0)\n"
        "    snap = os.path.join(os.environ['SNAP'], 'tier_store')\n"
        "    deadline = time.monotonic() + 30\n"
        "    while not os.path.isdir(snap) and time.monotonic() < deadline:\n"
        "        time.sleep(0.05)\n"
        "    assert os.path.isdir(snap), 'no cold store yet'\n"
        "    if not os.path.exists(marker):\n"
        "        open(marker, 'w').close()\n"
        "        sys.exit(3)                  # a whole-job restart\n"
        "    final = cl.pull('t', 4, np.arange(64))\n"
        "    np.testing.assert_allclose(base - final, 1.0, rtol=1e-6)\n"
        "    print('TIER WORKER OK', flush=True)\n")
    snap = tmp_path / "snap"
    res = subprocess.run(
        LAUNCH + [f"--servers=127.0.0.1:{_free_port()}",
                  f"--workers=127.0.0.1:{_free_port()}",
                  "--max_restarts=1", "--restart_backoff=0.05",
                  "--ps_snapshot_dir", str(snap),
                  "--ps_tier_warm_bytes=64",
                  "--log_dir", str(tmp_path / "logs"), str(script)],
        env=_env(SNAP=str(snap)), capture_output=True, text=True,
        timeout=120)
    logs = _logs(tmp_path / "logs")
    assert res.returncode == 0, (res.stderr, logs)
    assert "worker.0 exited with code 3" in res.stderr
    assert "elastic restart 1/1" in res.stderr
    assert "TIER WORKER OK" in logs

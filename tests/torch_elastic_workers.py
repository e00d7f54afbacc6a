"""Helpers of the port's elastic drills: the env of
tests/torch_elastic_trainer.py, one life of a gang started directly or
a job under ``python -m paddle_tpu_torch.distributed.launch``, and the
loss curve a run leaves. Every process has a timeout."""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINER = os.path.join(REPO, "tests", "torch_elastic_trainer.py")
REF_FIXTURE = os.path.join(REPO, "tests", "fixtures", "elastic_trainer.py")
DRILL_STEPS = 12


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def drill_env(out, ckpt, **extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               ELASTIC_DRILL_OUT=str(out),
               PADDLE_TPU_CLUSTER_CKPT_DIR=str(ckpt),
               ELASTIC_DRILL_STEPS=str(DRILL_STEPS),
               ELASTIC_DRILL_SAVE_EVERY="2",
               ELASTIC_DRILL_STEP_SLEEP="0.02")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    for k in list(env):
        if k.startswith(("PADDLE_PS_FAULT_", "PADDLE_TRAINER",
                         "PADDLE_CURRENT_ENDPOINT", "PADDLE_COORDINATOR",
                         "PADDLE_ELASTIC_")):
            env.pop(k)
    env.update({k: str(v) for k, v in extra.items()})
    return env


def spawn_world(out, ckpt, world, script=TRAINER, timeout=120, **extra):
    """One life of a `world`-rank gang started directly (no launcher),
    with the launcher's PADDLE_* env on fresh ports: (exit codes,
    outputs)."""
    eps = [f"127.0.0.1:{free_port()}" for _ in range(world)]
    procs = []
    for r in range(world):
        env = drill_env(out, ckpt, **extra)
        env.update(PADDLE_TRAINERS_NUM=str(world),
                   PADDLE_TRAINER_ID=str(r),
                   PADDLE_TRAINER_ENDPOINTS=",".join(eps),
                   PADDLE_CURRENT_ENDPOINT=eps[r],
                   PADDLE_COORDINATOR=eps[0])
        procs.append(subprocess.Popen(
            [sys.executable, script], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], outs


def run_launcher(args, env, timeout=180, script=TRAINER):
    """The trainer under the port's launcher on fresh ports."""
    return subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         f"--started_port={free_port()}"] + args + [script],
        env=env, capture_output=True, text=True, timeout=timeout)


def records(out, rank=0) -> list[dict]:
    with open(os.path.join(str(out), f"loss_rank{rank}.jsonl")) as f:
        return [json.loads(line) for line in f]


def curve(out, rank=0) -> dict:
    """step -> (loss, world); the LAST record of a step wins (a killed
    life's tail is recomputed by the resumed one)."""
    return {r["step"]: (r["loss"], r["world"]) for r in records(out, rank)}

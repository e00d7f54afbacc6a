"""Elastic drills of the port, part 2 (tests/torch_elastic_trainer.py,
``linreg`` on the CPU over gloo), with the assertions and bounds of
tests/test_elastic_training.py:

  * rank 1 crashes at step 7 in every life: after --flap_threshold 2
    the launcher excludes it and the job finishes at world 1 through the
    resize restore, within rtol 1e-6 of the world-2 curve;
  * rank 1 wedges at step 0 (the ``trainer_step`` stall) while its
    heartbeat thread keeps beating: --step_deadline catches the frozen
    step, the gang restarts and finishes with the fault-free curve bit
    for bit. Rank 0 waits for rank 1 at the step's all-reduce, so its
    step freezes too, and the manager reports the deadlocked gang
    (ranks [0, 1]) where the JAX fixture, which has no collective,
    reports rank 1 alone;
  * a kill inside the asynchronous cluster save (the store's writer
    thread) keeps the previous committed version, bit-equal.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import torch_elastic_workers as W
from paddle_tpu_torch.distributed.cluster_ckpt import ClusterCheckpoint
from paddle_tpu_torch.distributed.fleet.runtime.fault_injection import (
    KILL_EXIT_CODE)


@pytest.fixture(scope="module")
def baseline_world2(tmp_path_factory):
    base = tmp_path_factory.mktemp("elastic_baseline")
    out, ckpt = base / "out", base / "ckpt"
    rcs, outs = W.spawn_world(out, ckpt, world=2)
    assert rcs == [0, 0], outs
    f0 = np.load(os.path.join(str(out), "final_rank0.npz"))
    f1 = np.load(os.path.join(str(out), "final_rank1.npz"))
    return {"curve": W.curve(out),
            "M_full": np.concatenate([f0["M"], f1["M"]], axis=0)}


def test_drill_exclude_flapping_rank_resumes_at_world_minus_1(
        tmp_path, baseline_world2):
    out, ckpt, logs = (tmp_path / d for d in ("out", "ckpt", "logs"))
    env = W.drill_env(out, ckpt, ELASTIC_DRILL_FLAP_RANK=1,
                      ELASTIC_DRILL_KILL_AT=7)
    res = W.run_launcher(
        ["--nproc_per_node=2", "--log_dir", str(logs),
         "--max_restarts=4", "--restart_backoff=0.05",
         "--exclude_flapping", "--flap_threshold=2",
         f"--cluster_ckpt_dir={ckpt}"], env)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "excluding flapping rank trainer.1" in res.stderr, res.stderr
    got = W.curve(out)
    assert got[6][1] == 2 and got[11][1] == 1        # finished at W-1
    want = baseline_world2["curve"]
    for s in range(W.DRILL_STEPS):
        np.testing.assert_allclose(got[s][0], want[s][0], rtol=1e-6)
    fin = np.load(os.path.join(str(out), "final_rank0.npz"))
    assert fin["M"].shape[0] == 24                   # owns every row now
    np.testing.assert_allclose(fin["M"], baseline_world2["M_full"],
                               rtol=1e-6)


def test_drill_hung_rank_detected_and_job_recovers(tmp_path,
                                                   baseline_world2):
    out, ckpt, logs = (tmp_path / d for d in ("out", "ckpt", "logs"))
    env = W.drill_env(out, ckpt, ELASTIC_DRILL_STALL_RANK=1,
                      ELASTIC_DRILL_STALL=60,
                      ELASTIC_DRILL_STEP_SLEEP="0.3")
    res = W.run_launcher(
        ["--nproc_per_node=2", "--log_dir", str(logs),
         "--max_restarts=1", "--restart_backoff=0.05",
         "--step_deadline=1.0", f"--cluster_ckpt_dir={ckpt}"], env)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "ranks [0, 1]" in res.stderr, res.stderr  # the frozen gang
    assert "elastic restart 1/1" in res.stderr
    got = W.curve(out)
    want = baseline_world2["curve"]
    assert set(got) == set(range(W.DRILL_STEPS))
    for s in range(W.DRILL_STEPS):
        assert got[s][0] == want[s][0], f"step {s} diverged"


def test_drill_kill_mid_cluster_save_keeps_previous_version(tmp_path):
    out, ckpt = tmp_path / "out", tmp_path / "ckpt"
    rcs, outs = W.spawn_world(out, ckpt, world=1)     # commits thru 10
    assert rcs == [0], outs
    ck = ClusterCheckpoint(str(ckpt), rank=0, world=1)
    before, info = ck.restore()
    assert info["step"] == 10

    env = W.drill_env(out, ckpt, ELASTIC_DRILL_STEPS=W.DRILL_STEPS + 6,
                      PADDLE_TRAINERS_NUM=1, PADDLE_TRAINER_ID=0,
                      PADDLE_PS_FAULT_KILL_AFTER_BYTES=64)
    res = subprocess.run([sys.executable, W.TRAINER], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == KILL_EXIT_CODE, res.stdout + res.stderr

    after, info2 = ClusterCheckpoint(str(ckpt), rank=0,
                                     world=1).restore()
    assert info2["step"] == 10
    for k in before:
        np.testing.assert_array_equal(after[k], before[k])

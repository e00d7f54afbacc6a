"""Elastic drills of the port, part 1 (tests/torch_elastic_trainer.py,
``linreg`` on the CPU over gloo), with the assertions and bounds of
tests/test_elastic_training.py:

  * the fault-free world-2 curve and final state equal the JAX
    fixture's (tests/fixtures/elastic_trainer.py) within rtol 1e-12;
  * rank 1 killed at step 7 under the launcher (--max_restarts 2,
    backoff 0.05 s): the gang restarts, resumes from its cluster
    checkpoint, and every step's loss and the final state equal the
    fault-free run's bit for bit;
  * world 4 commits step 4, the job comes back at world 2: the shards
    re-cut, the schedule repartitions, and the curve continues the
    world-2 run's within rtol 1e-6.

The ranks sum their gradients with a real all-reduce, unlike the JAX
fixture (which computes every rank's share in each process); the other
drills are in test_torch_elastic_drills_faults.py.
"""
import os

import numpy as np
import pytest

import torch_elastic_workers as W


@pytest.fixture(scope="module")
def baseline_world2(tmp_path_factory):
    """Fault-free world-2 run: the reference loss curve + final state."""
    base = tmp_path_factory.mktemp("elastic_baseline")
    out, ckpt = base / "out", base / "ckpt"
    rcs, outs = W.spawn_world(out, ckpt, world=2)
    assert rcs == [0, 0], outs
    f0 = np.load(os.path.join(str(out), "final_rank0.npz"))
    f1 = np.load(os.path.join(str(out), "final_rank1.npz"))
    return {"out": str(out), "curve": W.curve(out), "final": f0,
            "M_full": np.concatenate([f0["M"], f1["M"]], axis=0)}


def test_linreg_curve_matches_the_jax_fixture(tmp_path, baseline_world2):
    out, ckpt = tmp_path / "out", tmp_path / "ckpt"
    rcs, outs = W.spawn_world(out, ckpt, world=2, script=W.REF_FIXTURE)
    assert rcs == [0, 0], outs
    want = W.curve(out)
    got = baseline_world2["curve"]
    assert set(got) == set(want) == set(range(W.DRILL_STEPS))
    for s in range(W.DRILL_STEPS):
        np.testing.assert_allclose(got[s][0], want[s][0], rtol=1e-12,
                                   err_msg=f"step {s}")
        assert got[s][1] == want[s][1] == 2
    f0 = np.load(os.path.join(str(out), "final_rank0.npz"))
    f1 = np.load(os.path.join(str(out), "final_rank1.npz"))
    np.testing.assert_allclose(baseline_world2["final"]["w"], f0["w"],
                               rtol=1e-12)
    np.testing.assert_allclose(baseline_world2["M_full"],
                               np.concatenate([f0["M"], f1["M"]]),
                               rtol=1e-12)


def test_drill_kill_resume_bit_for_bit(tmp_path, baseline_world2):
    out, ckpt, logs = (tmp_path / d for d in ("out", "ckpt", "logs"))
    env = W.drill_env(out, ckpt, ELASTIC_DRILL_KILL_RANK=1,
                      ELASTIC_DRILL_KILL_AT=7)
    res = W.run_launcher(
        ["--nproc_per_node=2", "--log_dir", str(logs),
         "--max_restarts=2", "--restart_backoff=0.05",
         f"--cluster_ckpt_dir={ckpt}"], env)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "trainer.1 exited with code 23" in res.stderr, res.stderr
    assert "elastic restart 1/2" in res.stderr
    assert "backing off" in res.stderr
    got = W.curve(out)
    want = baseline_world2["curve"]
    assert set(got) == set(range(W.DRILL_STEPS))
    for s in range(W.DRILL_STEPS):
        assert got[s][0] == want[s][0], \
            f"step {s}: {got[s][0]!r} != {want[s][0]!r} (not bit-for-bit)"
    # the kill waits for step 6's version: the gang resumes at 7
    assert {r["resumed_from"] for r in W.records(out)} == {None, 7}
    fin = np.load(os.path.join(str(out), "final_rank0.npz"))
    np.testing.assert_array_equal(fin["w"], baseline_world2["final"]["w"])
    np.testing.assert_array_equal(fin["M"], baseline_world2["final"]["M"])


def test_drill_resize_4_to_2_continues_loss_curve(tmp_path,
                                                  baseline_world2):
    out, ckpt = tmp_path / "out", tmp_path / "ckpt"
    rcs, outs = W.spawn_world(out, ckpt, world=4,
                              ELASTIC_DRILL_STEPS=6)  # commits step 4
    assert rcs == [0] * 4, outs
    rcs, outs = W.spawn_world(out, ckpt, world=2)     # resumes at 5
    assert rcs == [0, 0], outs
    got = W.curve(out)
    assert got[4][1] == 4 and got[5][1] == 2         # resize happened
    want = baseline_world2["curve"]
    for s in range(W.DRILL_STEPS):
        np.testing.assert_allclose(
            got[s][0], want[s][0], rtol=1e-6,
            err_msg=f"step {s} diverged past fp tolerance")
    f0 = np.load(os.path.join(str(out), "final_rank0.npz"))
    f1 = np.load(os.path.join(str(out), "final_rank1.npz"))
    M = np.concatenate([f0["M"], f1["M"]], axis=0)
    np.testing.assert_allclose(M, baseline_world2["M_full"], rtol=1e-6)

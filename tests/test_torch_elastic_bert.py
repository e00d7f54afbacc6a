"""The port's elastic drill in ``bert`` mode on the CPU
(tests/torch_elastic_trainer.py): BERT-tiny (2 layers, hidden 64) at dp
2 through ``TrainStep(mesh=make_mesh({"dp": 2}))`` over gloo, AdamW and
AMP O1, dropout 0.1, 8 steps of the 16-sequence global batch, async
cluster saves every 2 steps (float32 parameters and Adam slots
replicated, the schedule cursor per rank).

Rank 1 is killed at step 5 under the launcher, once step 4's version
has committed; the gang restarts, the restarted rank 0 binds the same
rendezvous port again, both ranks restore step 4's version, and every
step's loss and every final parameter equal the fault-free run's bit
for bit. The chip smoke's
``elastic`` phase runs the same drill at BERT-base on the card.
"""
import os

import numpy as np
import pytest

import torch_elastic_workers as W

STEPS = 8


def _bert_env(out, ckpt, **extra):
    return W.drill_env(out, ckpt, ELASTIC_DRILL_MODEL="bert",
                       ELASTIC_DRILL_DEVICE="cpu",
                       ELASTIC_DRILL_BERT_SIZE="tiny",
                       ELASTIC_DRILL_STEPS=STEPS,
                       ELASTIC_DRILL_STEP_SLEEP=0, **extra)


def _launch(tmp, args=(), **extra):
    out, ckpt, logs = (tmp / d for d in ("out", "ckpt", "logs"))
    res = W.run_launcher(
        ["--nproc_per_node=2", "--log_dir", str(logs),
         f"--cluster_ckpt_dir={ckpt}", *args], _bert_env(out, ckpt, **extra),
        timeout=240)
    assert res.returncode == 0, res.stderr[-3000:] + "".join(
        open(os.path.join(logs, f)).read()[-3000:]
        for f in sorted(os.listdir(logs)))
    return out, res


@pytest.fixture(scope="module")
def fault_free(tmp_path_factory):
    out, _ = _launch(tmp_path_factory.mktemp("bert_base_run"))
    return out


def test_bert_drill_fault_free_run(fault_free):
    for r in (0, 1):
        recs = W.records(fault_free, r)
        assert [x["step"] for x in recs] == list(range(STEPS))
        assert all(np.isfinite(x["loss"]) for x in recs)
        last = recs[-1]
        assert last["device"] == "cpu" and last["backend"] == "gloo"
        assert last["world"] == 2 and last["resumed_from"] is None
        assert [s["step"] for s in last["saves"]] == [2, 4, 6]
        # both ranks report the global batch's loss
    assert W.curve(fault_free, 0) == W.curve(fault_free, 1)


def test_bert_drill_kill_resume_bit_for_bit(tmp_path, fault_free):
    out, res = _launch(tmp_path, ("--max_restarts=2",
                                  "--restart_backoff=0.05"),
                       ELASTIC_DRILL_KILL_RANK=1, ELASTIC_DRILL_KILL_AT=5)
    assert "trainer.1 exited with code 23" in res.stderr, res.stderr
    assert "elastic restart 1/2" in res.stderr
    got, want = W.curve(out), W.curve(fault_free)
    assert set(got) == set(range(STEPS))
    for s in range(STEPS):
        assert got[s][0] == want[s][0], \
            f"step {s}: {got[s][0]!r} != {want[s][0]!r} (not bit-for-bit)"
    recs = W.records(out)
    # the kill waits for step 4's version: both ranks resume at 5
    assert {r["resumed_from"] for r in recs} == {None, 5}
    assert {r["resumed_from"] for r in W.records(out, 1)} == {None, 5}
    assert all(r["restore_s"] is not None for r in recs
               if r["resumed_from"] is not None)
    a = np.load(os.path.join(str(fault_free), "final_rank0.npz"))
    b = np.load(os.path.join(str(out), "final_rank0.npz"))
    assert sorted(a.files) == sorted(b.files) and len(a.files) > 30
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)

"""Seeded collective trainer of the port's elastic drills, started by
``python -m paddle_tpu_torch.distributed.launch`` (or directly, one
process per rank, with the launcher's PADDLE_* env).

The env contract is the JAX package's drill fixture's
(tests/fixtures/elastic_trainer.py):

  ELASTIC_DRILL_OUT         output dir (jsonl / npz / arming markers)
  ELASTIC_DRILL_STEPS       total steps (default 12)
  ELASTIC_DRILL_SAVE_EVERY  checkpoint cadence (default 2)
  ELASTIC_DRILL_STEP_SLEEP  seconds per step (default 0.05)
  ELASTIC_DRILL_KILL_RANK   rank to kill ONCE (first life only)
  ELASTIC_DRILL_FLAP_RANK   rank to kill EVERY life (crash loop /
                            exclusion drills)
  ELASTIC_DRILL_KILL_AT     step number the kill fires at (once the
                            newest version due before it has committed)
  ELASTIC_DRILL_STALL_RANK / ELASTIC_DRILL_STALL  hang one rank at
                            ELASTIC_DRILL_KILL_AT for N seconds
  PADDLE_TPU_CLUSTER_CKPT_DIR  the cluster checkpoint root

and, of the port's trainer alone:

  ELASTIC_DRILL_MODEL       linreg (default) or bert
  ELASTIC_DRILL_DEVICE      bert's device: cuda (default) or cpu
  ELASTIC_DRILL_BERT_SIZE   base (default: bench.py's bench_bert, BERT-base
                            16 x 128, 19 masked positions) or tiny (2
                            layers, hidden 64, 16 x 64, 8 positions)
  ELASTIC_DRILL_BERT_LAYERS that size's encoder layers cut to this many
                            (default: the size's own)
  ELASTIC_DRILL_DROPOUT     bert's hidden and attention dropout (0.1)

The ranks join one process group (``env.init_parallel_env``: gloo on
the CPU and for ranks sharing a card) and sum their gradients with a
real all-reduce.

- ``linreg``: the JAX fixture's model and state layout, in float64 on
  the CPU: ``w`` and momentum ``v`` replicated, ``M`` (24 x 3) sharded
  on axis 0 (each owned row accumulates ``(row + 1) * loss``), a
  per-rank ``rng`` counter. Each rank computes the gradient and loss of
  its slice of the step's global batch; the all-reduce sums them in
  rank order (world 2: the fixture's sum, bit for bit).
- ``bert``: ``TrainStep(mesh=make_mesh({"dp": W}))`` with AdamW lr 1e-4
  and AMP O1 on a seeded corpus of 512 masked-LM sequences; the step's
  global batch is ``SampleSchedule(seed, 0, 512, 16)``'s. Saved: every
  parameter (float32 masters) with its Moment1 / Moment2 / Beta1Pow /
  Beta2Pow replicated, the step, and the rank's schedule cursor
  per-rank. The dropout seed is ``step + 1``, passed explicitly: the
  step's own counter restarts at 0 in a resumed life.

Every step appends one record to ``loss_rank<r>.jsonl``: the step,
loss, world, rank, wall time (and since the process started), this
life's pid and the step it resumed from, and (bert) the step's seconds,
the seconds from the process start to each setup stage (first record
of a life: imports, rendezvous, model, train step, restore), the
restore's seconds and those of
the copies onto the device, the device and backend, the kernels built
in this process, the life's kernel launch counts so far, and the
cluster saves' host-copy seconds and writer-thread events (a life that
ends whole adds its last ones to ``saves_rank<r>.jsonl``). A life ends
as ``distributed.spawn``'s workers do (``spawn._leave``): barrier, group
destroyed, atexit hooks, ``os._exit(0)``.
"""
import json
import os
import time

import numpy as np

T0 = time.time()                   # this life's start, for its records
SETUP = {}                         # seconds from T0 to each setup stage
RANK = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
WORLD = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
OUT = os.environ["ELASTIC_DRILL_OUT"]
ROOT = os.environ["PADDLE_TPU_CLUSTER_CKPT_DIR"]
STEPS = int(os.environ.get("ELASTIC_DRILL_STEPS", "12"))
SAVE_EVERY = int(os.environ.get("ELASTIC_DRILL_SAVE_EVERY", "2"))
STEP_SLEEP = float(os.environ.get("ELASTIC_DRILL_STEP_SLEEP", "0.05"))
KILL_RANK = int(os.environ.get("ELASTIC_DRILL_KILL_RANK", "-1"))
FLAP_RANK = int(os.environ.get("ELASTIC_DRILL_FLAP_RANK", "-1"))
KILL_AT = os.environ.get("ELASTIC_DRILL_KILL_AT", "")
STALL_RANK = int(os.environ.get("ELASTIC_DRILL_STALL_RANK", "-1"))
STALL = os.environ.get("ELASTIC_DRILL_STALL", "")
MODEL = os.environ.get("ELASTIC_DRILL_MODEL", "linreg")
# the JAX fixture merges within 5 s; a loaded host (six test workers) or
# a 1.3 GB part can take longer between two ranks' parts
MERGE_TIMEOUT = 60.0

os.makedirs(OUT, exist_ok=True)

# arm the deterministic faults BEFORE the injector's first use:
# KILL_RANK dies once (a marker file remembers the spent life across
# restarts — the launcher reruns us with the same env), FLAP_RANK dies
# every life
arm_kill = False
if KILL_AT:
    if RANK == FLAP_RANK:
        arm_kill = True
    elif RANK == KILL_RANK:
        marker = os.path.join(OUT, "kill_spent")
        if not os.path.exists(marker):
            with open(marker, "w"):
                pass
            arm_kill = True
if arm_kill:
    os.environ["PADDLE_PS_FAULT_KILL_AT_STEP"] = KILL_AT
else:
    os.environ.pop("PADDLE_PS_FAULT_KILL_AT_STEP", None)
arm_stall = False
if STALL and RANK == STALL_RANK:
    marker = os.path.join(OUT, "stall_spent")   # first life only
    if not os.path.exists(marker):
        with open(marker, "w"):
            pass
        arm_stall = True
if arm_stall:
    os.environ["PADDLE_PS_FAULT_STALL"] = STALL
    os.environ["PADDLE_PS_FAULT_STALL_POINT"] = "trainer_step"
else:
    for _k in ("PADDLE_PS_FAULT_STALL", "PADDLE_PS_FAULT_STALL_POINT"):
        os.environ.pop(_k, None)
if MODEL == "bert" and os.environ.get("ELASTIC_DRILL_DEVICE",
                                      "cuda") != "cpu":
    # cuBLAS picks a deterministic workspace only if told before CUDA
    # starts: a resumed life must rerun the fault-free one bit for bit
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

from paddle_tpu_torch.distributed import elastic, env  # noqa: E402
from paddle_tpu_torch.distributed.cluster_ckpt import (  # noqa: E402
    ClusterCheckpoint, SampleSchedule)
from paddle_tpu_torch.distributed.collective import all_reduce  # noqa: E402
from paddle_tpu_torch.distributed.spawn import _leave  # noqa: E402

SEED = 7
SETUP["imports"] = time.time() - T0


def settle_before_kill(ck, step):
    """The armed rank lets the newest version due before its kill commit
    first (bounded by the merge timeout): an async save of a large state
    can still be in its writer when the kill step comes, and the drill
    is of the resume, so its resume point must not race the writer.
    The moment of the kill goes to ``kills.jsonl``."""
    if not arm_kill or step != int(KILL_AT):
        return
    due = [s for s in range(1, step) if ck.due(s)]
    if not due:
        return
    ck.wait()                      # this rank's own part
    deadline = time.monotonic() + MERGE_TIMEOUT
    while (ck.latest_step() or -1) < due[-1] \
            and time.monotonic() < deadline:
        time.sleep(0.05)
    with open(os.path.join(OUT, "kills.jsonl"), "a") as f:
        f.write(json.dumps({"rank": RANK, "step": step,
                            "t": time.time()}) + "\n")


def linreg(ck, log):
    N, G, DIM, ROWS = 256, 8, 4, 24
    rs = np.random.RandomState(SEED)
    X = rs.randn(N, DIM)
    y = X @ np.arange(1.0, DIM + 1)
    sched = SampleSchedule(seed=SEED, epoch=0, num_samples=N,
                           global_batch=G)
    base, rem = divmod(ROWS, WORLD)
    row_lo = RANK * base + min(RANK, rem)
    my_rows = np.arange(row_lo, row_lo + base + (1 if RANK < rem else 0))
    w, v = np.zeros(DIM), np.zeros(DIM)
    M = np.zeros((len(my_rows), 3))
    start, resumed = 0, None
    if ClusterCheckpoint.exists(ROOT):
        state, info = ck.restore()
        w, v, M = state["w"], state["v"], state["M"]
        start = resumed = info["step"] + 1
        assert M.shape[0] == len(my_rows), \
            f"reshard: got {M.shape[0]} rows, own {len(my_rows)}"
    elastic.start_heartbeat(interval=0.1)
    per = G // WORLD
    for step in range(start, STEPS):
        settle_before_kill(ck, step)
        elastic.note_step(step)  # heartbeat progress + fault hooks
        sl = sched.rank_indices(step, RANK, WORLD)
        err = X[sl] @ w - y[sl]
        part = np.concatenate([X[sl].T @ err / per,
                               [float(np.mean(err ** 2))]])
        tot = all_reduce(torch.from_numpy(part)).numpy()
        grad = tot[:DIM] / WORLD
        loss = float(tot[DIM]) / WORLD
        v = 0.9 * v + grad
        w = w - 0.05 * v
        M += (my_rows[:, None] + 1) * loss
        log({"step": step, "loss": loss, "resumed_from": resumed})
        ck.maybe_save(step, replicated={"w": w, "v": v},
                      sharded={"M": M},
                      per_rank={"rng": np.array([step], np.int64)},
                      extra_meta={"loss": loss})
        if STEP_SLEEP:
            time.sleep(STEP_SLEEP)
    ck.wait()
    np.savez(os.path.join(OUT, f"final_rank{RANK}.npz"),
             w=w, v=v, M=M, rows=my_rows)


def bert_corpus(cfg, n, seq, n_pred):
    """n masked-LM sequences from RandomState(SEED): bench.py's
    bench_bert batch recipe, at corpus size."""
    rng = np.random.RandomState(SEED)
    ids = rng.randint(4, cfg.vocab_size, (n, seq)).astype("int64")
    pos = np.stack([np.sort(rng.choice(seq, n_pred, replace=False))
                    for _ in range(n)]).astype("int64")
    mlm = np.take_along_axis(ids, pos, axis=1)
    nsp = rng.randint(0, 2, (n, 1)).astype("int64")
    return ids, pos, mlm, nsp


def bert(ck, log):
    from paddle_tpu_torch.distributed.mesh import make_mesh
    from paddle_tpu_torch.jit import make_train_step
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.nn import initializer
    from paddle_tpu_torch.observability.flight import RECORDER
    from paddle_tpu_torch.observability.registry import REGISTRY
    from paddle_tpu_torch.ops import _build, launch_counts, \
        reset_launch_counts
    device = os.environ.get("ELASTIC_DRILL_DEVICE", "cuda")
    if device != "cpu":
        if not torch.cuda.is_available():
            raise RuntimeError("bert drill: no CUDA card")
        from paddle_tpu_torch.models.gpt import disable_tf32
        disable_tf32()
        torch.use_deterministic_algorithms(True)
    p = float(os.environ.get("ELASTIC_DRILL_DROPOUT", "0.1"))
    drop = dict(hidden_dropout_prob=p, attention_probs_dropout_prob=p)
    if os.environ.get("ELASTIC_DRILL_BERT_LAYERS"):
        drop["num_hidden_layers"] = int(
            os.environ["ELASTIC_DRILL_BERT_LAYERS"])
    if os.environ.get("ELASTIC_DRILL_BERT_SIZE", "base") == "tiny":
        cfg, seq, n_pred = BertConfig.tiny(**drop), 64, 8
    else:
        cfg, seq, n_pred = BertConfig.base(**drop), 128, 19
    N, G = 512, 16
    corpus = bert_corpus(cfg, N, seq, n_pred)
    sched = SampleSchedule(seed=SEED, epoch=0, num_samples=N,
                           global_batch=G)
    initializer.seed(0)
    model = BertForPretraining(cfg)
    model.train()
    SETUP["model"] = time.time() - T0

    def loss_fn(m, ids, pos, mlm, nsp):
        logits, nsp_logits = m(ids, masked_positions=pos)
        return m.loss(logits, nsp_logits, mlm, nsp)

    step_fn = make_train_step(
        model, loss_fn, optimizer="adamw", lr=1e-4, amp_level="O1",
        device=device, mesh=make_mesh({"dp": WORLD}) if WORLD > 1 else None)
    SETUP["train_step"] = time.time() - T0
    slots = ("Moment1", "Moment2", "Beta1Pow", "Beta2Pow")
    start, resumed, restore_s, upload_s = 0, None, None, None
    if ClusterCheckpoint.exists(ROOT):
        state, info = ck.restore()
        # the restore's own seconds (paddle_tpu_elastic_resume_seconds),
        # then the copies into the step's tensors
        restore_s = REGISTRY.get("paddle_tpu_elastic_resume_seconds").sum
        t0 = time.perf_counter()
        with torch.no_grad():
            for n, prm in step_fn.params.items():
                prm.copy_(torch.from_numpy(state[n]))
                for k in slots:
                    step_fn.opt_state[n][k].copy_(
                        torch.from_numpy(state[f"{n}.{k}"]))
        if device != "cpu":
            torch.cuda.synchronize()
        upload_s = time.perf_counter() - t0
        start = resumed = info["step"] + 1
    SETUP["restore"] = time.time() - T0
    built_here = sorted(_build.build_log())
    penv = env.ParallelEnv()
    elastic.start_heartbeat(interval=0.1)
    reset_launch_counts()
    saves = []

    def writes():
        return [dict(e.attrs) for e in RECORDER.events("ckpt")
                if e.kind == "write_done"]

    for step in range(start, STEPS):
        settle_before_kill(ck, step)
        elastic.note_step(step)
        idx = sched.global_indices(step)
        t0 = time.perf_counter()
        loss = float(step_fn(*(a[idx] for a in corpus), seed=step + 1))
        step_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rep = dict(step_fn.params)
        for n, st in step_fn.opt_state.items():
            rep.update({f"{n}.{k}": st[k] for k in slots})
        rep["step"] = np.array(step, np.int64)
        if ck.maybe_save(step, replicated=rep,
                         per_rank={"cursor": np.array([step + 1],
                                                      np.int64)},
                         extra_meta={"loss": loss}) is not None:
            saves.append({"step": step,
                          "host_copy_s": time.perf_counter() - t0})
        log({"step": step, "loss": loss, "step_s": step_s,
             "setup": SETUP if step == start else None,
             "resumed_from": resumed, "restore_s": restore_s,
             "upload_s": upload_s, "device": str(step_fn.device),
             "backend": penv.backend, "built_here": built_here,
             "counts": launch_counts(), "saves": saves,
             "writes": writes()})
        if STEP_SLEEP:
            time.sleep(STEP_SLEEP)
    ck.wait()
    # the life's last writes land after its last step record
    with open(os.path.join(OUT, f"saves_rank{RANK}.jsonl"), "a") as f:
        f.write(json.dumps({"pid": os.getpid(), "saves": saves,
                            "writes": writes()}) + "\n")
    if RANK == 0:
        np.savez(os.path.join(OUT, "final_rank0.npz"),
                 **{n: v.detach().cpu().numpy()
                    for n, v in step_fn.params.items()})


def main():
    if MODEL != "bert" or os.environ.get("ELASTIC_DRILL_DEVICE") == "cpu":
        # ranks share the host's cores: one thread each, else two ranks
        # oversubscribe them many times over
        torch.set_num_threads(1)
    else:
        # on the card the host still builds the model: each rank takes
        # its share of the cores (with every core each, two ranks spent
        # 12-14 s in BertForPretraining's init on an 8-core host)
        torch.set_num_threads(max(1, torch.get_num_threads() // WORLD))
    env.init_parallel_env()
    SETUP["rendezvous"] = time.time() - T0
    ck = ClusterCheckpoint(ROOT, rank=RANK, world=WORLD,
                           every_steps=SAVE_EVERY,
                           merge_timeout=MERGE_TIMEOUT)
    losses = open(os.path.join(OUT, f"loss_rank{RANK}.jsonl"), "a")
    pid = os.getpid()

    def log(rec):
        t = time.time()
        rec.update(world=WORLD, rank=RANK, t=t, pid=pid,
                   since_start=t - T0)
        losses.write(json.dumps(rec) + "\n")
        losses.flush()
        os.fsync(losses.fileno())

    (bert if MODEL == "bert" else linreg)(ck, log)
    losses.close()
    print(f"TRAINER {RANK}/{WORLD} DONE", flush=True)
    _leave()                       # as distributed.spawn's workers do


if __name__ == "__main__":
    main()

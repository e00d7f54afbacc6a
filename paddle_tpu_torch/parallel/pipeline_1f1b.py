"""1F1B pipeline schedule (counterpart of
``paddle_tpu/parallel/pipeline_1f1b.py``).

The reference turns the 1F1B schedule into data: an event simulator
(``simulate_1f1b``) produces, for every clock tick and stage, which
action the stage takes (Forward on microbatch i / Backward on
microbatch j / idle) and which buffer slots it touches, and one SPMD
program steps the clock. The port runs one process per rank, so the
same tables drive a host loop per rank instead: ``stage_actions`` reads
stage s's actions off the tables in tick order, and the rank runs them
in that order, receiving each input from its neighbour stage as it
needs it (``parallel/pipeline.py``). The simulator's lockstep with one
tick of latency makes the order deadlock-free: a message a rank waits
for was sent at an earlier tick by an action that waited only on
earlier ticks.

The admission cap of the simulator (stage s holds at most S - s
microbatches in flight) is what keeps 1F1B's stored activations below
GPipe's: a stage keeps the autograd graph of a microbatch from its F
to its B. The last stage runs no separate forward: its B is blocks +
head + loss of one microbatch and their backward at once. The loss is
the mean over microbatches (each microbatch's cotangent 1/M).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

__all__ = ["Schedule", "simulate_1f1b", "stage_actions"]


@dataclasses.dataclass
class Schedule:
    """Static per-tick schedule tables, each [n_ticks, n_stages] int32.

    f_on/f_micro/f_slot: forward action (slot = x-buffer slot to read;
      stage 0 reads the resident microbatch inputs instead).
    b_on/b_micro/b_xslot/b_dxslot: backward action (xslot = stored input,
      dxslot = arrived cotangent; the last stage seeds its own cotangent).
    recv_on/recv_slot: an activation permuted in at the END of tick t-1 is
      committed into the x-buffer at the START of tick t.
    drecv_on/drecv_slot: same for cotangents.
    """
    n_ticks: int
    n_xslots: int
    n_dxslots: int
    f_on: Any; f_micro: Any; f_slot: Any
    b_on: Any; b_micro: Any; b_xslot: Any; b_dxslot: Any
    recv_on: Any; recv_slot: Any
    drecv_on: Any; drecv_slot: Any


def simulate_1f1b(n_stages: int, n_micro: int) -> Schedule:
    """Event-driven lockstep 1F1B: B-priority, one-tick communication
    latency, the last stage runs no separate forward (its B runs
    blocks + head + loss and their backward in one action). One action
    per stage per tick.

    Deterministic and purely host-side: ``stage_actions`` reads a
    rank's order of actions off the tables."""
    S, M = n_stages, n_micro
    assert S >= 2, "1F1B needs pp >= 2"
    # per stage state
    f_ready = [dict() for _ in range(S)]   # micro -> tick available
    b_ready = [dict() for _ in range(S)]
    x_slot = [dict() for _ in range(S)]    # micro -> xbuf slot
    dx_slot = [dict() for _ in range(S)]
    x_free = [set() for _ in range(S)]
    dx_free = [set() for _ in range(S)]
    x_hwm = [0] * S                        # slot high-water mark
    dx_hwm = [0] * S
    f_done = [0] * S
    b_done = [0] * S
    for m in range(M):
        f_ready[0][m] = 0                  # stage 0 inputs resident
    rows = []
    t = 0
    while sum(b_done) < S * M or sum(f_done) < (S - 1) * M:
        assert t < 8 * (M + S) + 64, "1F1B schedule failed to converge"
        row = {k: [0] * S for k in
               ("f_on", "f_micro", "f_slot", "b_on", "b_micro", "b_xslot",
                "b_dxslot", "recv_on", "recv_slot", "drecv_on",
                "drecv_slot")}
        acts = []
        for s in range(S):
            bs = [m for m, tk in b_ready[s].items() if tk <= t]
            # 1F1B admission cap: stage s keeps at most S-s microbatches
            # in flight (the warmup depth), so stored activations stay
            # O(pp) — B-priority alone lets warmup overfill downstream
            # buffers (Megatron num_warmup_microbatches semantics)
            fs = [m for m, tk in f_ready[s].items() if tk <= t] \
                if s < S - 1 and f_done[s] - b_done[s] < S - s else []
            if bs:                         # 1F1B: backward has priority
                m = min(bs)
                row["b_on"][s] = 1
                row["b_micro"][s] = m
                row["b_xslot"][s] = x_slot[s].get(m, 0)
                row["b_dxslot"][s] = dx_slot[s].get(m, 0)
                acts.append(("B", s, m))
            elif fs:
                m = min(fs)
                row["f_on"][s] = 1
                row["f_micro"][s] = m
                row["f_slot"][s] = x_slot[s].get(m, 0)
                acts.append(("F", s, m))
        # commit effects (arrivals land at t+1)
        for kind, s, m in acts:
            if kind == "F":
                del f_ready[s][m]
                f_done[s] += 1
                if s + 1 < S:
                    # allocate the receiver's x slot now; receiver commits
                    # the permuted activation at the start of t+1
                    free = x_free[s + 1]
                    slot = min(free) if free else x_hwm[s + 1]
                    if free and slot in free:
                        free.discard(slot)
                    else:
                        x_hwm[s + 1] += 1
                    x_slot[s + 1][m] = slot
                    if s + 1 == S - 1:
                        b_ready[S - 1][m] = t + 1   # last stage: B = remat
                    else:
                        f_ready[s + 1][m] = t + 1
            else:
                del b_ready[s][m]
                b_done[s] += 1
                if m in x_slot[s]:
                    x_free[s].add(x_slot[s][m])
                if m in dx_slot[s]:
                    dx_free[s].add(dx_slot[s][m])
                if s > 0:
                    free = dx_free[s - 1]
                    slot = min(free) if free else dx_hwm[s - 1]
                    if free and slot in free:
                        free.discard(slot)
                    else:
                        dx_hwm[s - 1] += 1
                    dx_slot[s - 1][m] = slot
                    b_ready[s - 1][m] = t + 1
        rows.append(row)
        t += 1
    # receive tables: stage s commits at tick t what was sent at t-1
    n_ticks = len(rows)
    for t in range(1, n_ticks):
        prev = rows[t - 1]
        for s in range(S):
            if s > 0 and prev["f_on"][s - 1] and s < S:
                m = prev["f_micro"][s - 1]
                rows[t]["recv_on"][s] = 1
                rows[t]["recv_slot"][s] = x_slot[s].get(m, 0)
            if s < S - 1 and prev["b_on"][s + 1]:
                m = prev["b_micro"][s + 1]
                rows[t]["drecv_on"][s] = 1
                rows[t]["drecv_slot"][s] = dx_slot[s].get(m, 0)
    tab = {k: np.asarray([r[k] for r in rows], np.int32)
           for k in rows[0]}
    return Schedule(n_ticks=n_ticks,
                    n_xslots=max(max(x_hwm), 1),
                    n_dxslots=max(max(dx_hwm), 1), **tab)


def stage_actions(sched: Schedule, stage: int) -> list[tuple[str, int]]:
    """Stage `stage`'s actions in tick order: ("F", m) / ("B", m); with
    one action a tick (the default schedule), a tick's B comes before
    its F, as the simulator gives B priority."""
    acts = []
    for t in range(sched.n_ticks):
        if sched.b_on[t, stage]:
            acts.append(("B", int(sched.b_micro[t, stage])))
        if sched.f_on[t, stage]:
            acts.append(("F", int(sched.f_micro[t, stage])))
    return acts

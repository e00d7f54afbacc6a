"""Heartbeats, hung-rank and straggler detection of the port
(paddle_tpu_torch/distributed/elastic.py) on the CPU, held to the JAX
package:

  * the in-process cases of tests/test_elastic.py,
    tests/test_elastic_training.py (content-based staleness, hung vs
    straggler) and tests/test_ps_fault_tolerance.py (the startup grace,
    legacy content, the server-restart budget);
  * heartbeat directories in both directions: one package's
    ``HeartbeatWriter`` writes, and both packages' ``stale_ranks`` and
    ``ElasticManager`` classify the ranks alike, poll by poll, on one
    fake clock.
"""
import os
import time

import pytest

from paddle_tpu.distributed import elastic as jelastic
from paddle_tpu_torch.distributed import elastic
from paddle_tpu_torch.distributed.elastic import (ElasticManager,
                                                  HeartbeatWriter,
                                                  stale_ranks)
from paddle_tpu_torch.observability.registry import REGISTRY

PKGS = {"port": elastic, "ref": jelastic}


def _write_hb(dir_, rank, start, beat, step):
    os.makedirs(dir_, exist_ok=True)
    p = os.path.join(dir_, f"rank{rank}.hb")
    with open(p + ".tmp", "w") as f:
        f.write(f"{start} {beat} {step}")
    os.replace(p + ".tmp", p)
    return p


# ---------------------------------------------------------------------------
# tests/test_elastic.py and tests/test_ps_fault_tolerance.py
# ---------------------------------------------------------------------------

def test_heartbeat_writer_and_stale_detection(tmp_path):
    hb = HeartbeatWriter(str(tmp_path), rank=0, interval=0.1).start()
    try:
        time.sleep(0.3)
        assert stale_ranks(str(tmp_path), timeout=5.0, expected=2) == [1]
        assert stale_ranks(str(tmp_path), timeout=5.0, expected=1) == []
    finally:
        hb.stop()
    time.sleep(0.4)
    assert stale_ranks(str(tmp_path), timeout=0.2, expected=1) == [0]


def test_stale_ranks_no_optin_is_silent(tmp_path):
    # nobody wrote a heartbeat => scripts didn't opt in => not hung
    assert stale_ranks(str(tmp_path), timeout=0.1, expected=4) == []


def test_stale_ranks_startup_grace(tmp_path):
    hb = HeartbeatWriter(str(tmp_path), rank=0, interval=0.1).start()
    try:
        time.sleep(0.25)
        # young job + grace: the not-yet-opted-in rank is NOT hung
        assert stale_ranks(str(tmp_path), timeout=5.0, expected=2,
                           grace=30.0) == []
        # no grace: reported immediately
        assert stale_ranks(str(tmp_path), timeout=5.0,
                           expected=2) == [1]
    finally:
        hb.stop()
    # job older than grace: missing rank IS reported
    with open(os.path.join(str(tmp_path), "rank0.hb"), "w") as f:
        f.write(f"{time.time() - 60} {time.time()}")
    assert stale_ranks(str(tmp_path), timeout=5.0, expected=2,
                       grace=30.0) == [1]


def test_stale_ranks_tolerates_garbage_and_legacy_content(tmp_path):
    # garbage and legacy single-timestamp files carry no start stamp:
    # grace cannot be established from them, so missing ranks are
    # reported the legacy way
    for content in ("not-a-timestamp", f"{time.time()}"):
        with open(os.path.join(str(tmp_path), "rank0.hb"), "w") as f:
            f.write(content)
        assert stale_ranks(str(tmp_path), timeout=5.0, expected=2,
                           grace=30.0) == [1]
        assert stale_ranks(str(tmp_path), timeout=5.0,
                           expected=2) == [1]


def test_stale_ranks_zero_expected(tmp_path):
    assert stale_ranks(str(tmp_path), timeout=1.0, expected=0) == []


def test_elastic_manager_server_restart_budget():
    m = ElasticManager(max_restarts=2)
    assert m.max_server_restarts == 2
    assert m.should_restart_server()
    m.record_server_restart()
    m.record_server_restart()
    assert not m.should_restart_server()
    assert m.should_restart()  # whole-job budget untouched


# ---------------------------------------------------------------------------
# tests/test_elastic_training.py: content-based staleness, hung vs slow
# ---------------------------------------------------------------------------

def test_stale_ranks_ignores_skewed_mtime(tmp_path):
    """Fresh CONTENT with an ancient mtime must NOT read as stale."""
    dir_ = str(tmp_path)
    now = time.time()
    p = _write_hb(dir_, 0, now - 100, now, step=5)
    os.utime(p, (now - 3600, now - 3600))     # mtime lies: 1h old
    assert stale_ranks(dir_, timeout=2.0, expected=1) == []


def test_stale_ranks_tracker_catches_frozen_content(tmp_path):
    """mtime keeps refreshing but the CONTENT never changes: the tracker
    catches it on the watcher's own monotonic clock."""
    dir_ = str(tmp_path)
    now = time.time()
    p = _write_hb(dir_, 0, now, now, step=5)
    tracker: dict = {}
    assert stale_ranks(dir_, 0.05, 1, tracker=tracker) == []
    time.sleep(0.12)
    os.utime(p, None)                         # fresh mtime, same bytes
    assert stale_ranks(dir_, 0.05, 1, tracker=tracker) == [0]


def _mgr(dir_, world, deadline=0.1, lag=10, pkg=elastic):
    return pkg.ElasticManager(
        max_restarts=3, heartbeat_timeout=30.0, heartbeat_dir=dir_,
        world_size=world, step_deadline=deadline, straggler_lag=lag)


def test_straggler_flagged_not_killed(tmp_path):
    dir_ = str(tmp_path)
    m = _mgr(dir_, world=2, deadline=30.0, lag=10)
    now = time.time()
    _write_hb(dir_, 0, now - 60, now, step=50)
    _write_hb(dir_, 1, now - 60, now, step=12)   # 38 behind, alive
    assert m.hung_ranks() == []
    assert m.stragglers() == [1]
    assert REGISTRY.get("paddle_tpu_elastic_straggler_ranks").value == 1
    assert REGISTRY.get("paddle_tpu_elastic_step_lag").value == 38
    assert REGISTRY.get("paddle_tpu_elastic_stale_ranks").value == 0


def test_step_frozen_rank_is_hung(tmp_path):
    dir_ = str(tmp_path)
    m = _mgr(dir_, world=2, deadline=0.08, lag=100)
    t0 = time.time()
    _write_hb(dir_, 0, t0 - 60, t0, step=5)
    _write_hb(dir_, 1, t0 - 60, t0, step=5)
    assert m.hung_ranks() == []               # first observation
    time.sleep(0.12)
    t1 = time.time()
    _write_hb(dir_, 0, t0 - 60, t1, step=6)   # advances, fresh beat
    _write_hb(dir_, 1, t0 - 60, t1, step=5)   # beats, step FROZEN
    assert m.hung_ranks() == [1]


def test_frozen_at_max_step_excused_while_others_advance(tmp_path):
    """A rank parked AT the front is not hung while a laggard advances;
    once every rank is frozen the whole gang is."""
    dir_ = str(tmp_path)
    m = _mgr(dir_, world=2, deadline=0.08, lag=100)
    t0 = time.time()
    _write_hb(dir_, 0, t0 - 60, t0, step=9)
    _write_hb(dir_, 1, t0 - 60, t0, step=3)
    assert m.hung_ranks() == []
    time.sleep(0.12)
    t1 = time.time()
    _write_hb(dir_, 0, t0 - 60, t1, step=9)   # frozen at the front
    _write_hb(dir_, 1, t0 - 60, t1, step=4)   # still moving
    assert m.hung_ranks() == []
    time.sleep(0.12)
    t2 = time.time()
    _write_hb(dir_, 0, t0 - 60, t2, step=9)
    _write_hb(dir_, 1, t0 - 60, t2, step=4)   # now BOTH frozen
    assert m.hung_ranks() == [0, 1]


def test_note_step_feeds_the_heartbeat(tmp_path, monkeypatch):
    """note_step publishes the step through the process's writer (the
    launcher's env starts it) and runs the injector's trainer hooks."""
    monkeypatch.setenv("PADDLE_ELASTIC_HEARTBEAT_DIR", str(tmp_path))
    monkeypatch.setenv("PADDLE_TRAINER_ID", "3")
    monkeypatch.setattr(elastic, "_writer", None)
    w = elastic.start_heartbeat(interval=0.05)
    try:
        assert elastic.start_heartbeat() is w            # idempotent
        elastic.note_step(17)
        time.sleep(0.2)
        hb = elastic.read_heartbeats(str(tmp_path), 4)
        assert hb[3]["step"] == 17 and hb[0] is None
    finally:
        w.stop()
        monkeypatch.setattr(elastic, "_writer", None)


def test_elastic_metrics_registered():
    for name in ("paddle_tpu_elastic_heartbeats_total",
                 "paddle_tpu_elastic_stale_ranks",
                 "paddle_tpu_elastic_straggler_ranks",
                 "paddle_tpu_elastic_step_lag",
                 "paddle_tpu_elastic_restarts_total",
                 "paddle_tpu_elastic_crash_loop_giveups_total"):
        assert REGISTRY.get(name) is not None, name


# ---------------------------------------------------------------------------
# heartbeat directories across the two packages, on one fake clock
# ---------------------------------------------------------------------------

class _Clock:
    """time.time / time.monotonic / time.sleep of both packages' elastic
    modules: one scripted clock, so both read the same ages."""

    def __init__(self):
        self.now = 1_000_000.0

    def time(self):
        return self.now

    def monotonic(self):
        return self.now

    def perf_counter(self):
        return self.now

    def sleep(self, s):
        self.now += s


# (seconds to advance, {rank: step to beat with, None: no beat}) — a
# four-rank job: ranks 0-2 start beating, rank 3 writes late (startup
# grace), rank 2 falls behind (straggler), rank 1's step freezes behind
# the front (hung), then every rank freezes (deadlocked gang)
_SCRIPT = [
    (0.0, {0: 0, 1: 0, 2: 0}),
    (1.0, {0: 1, 1: 1, 2: 0}),
    (1.0, {0: 3, 1: 2, 2: 0, 3: 0}),
    (1.0, {0: 14, 1: 3, 2: 1, 3: 14}),
    (2.5, {0: 20, 1: 3, 2: 2, 3: 20}),
    (2.5, {0: 26, 1: 3, 2: 3, 3: 26}),
    (2.5, {0: 26, 1: 3, 2: 3, 3: 26}),
    (2.5, {}),
    (25.0, {}),
]


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_heartbeat_dirs_classified_alike(tmp_path, monkeypatch, writer):
    """One package's HeartbeatWriter writes every rank's file; both
    packages' stale_ranks (stateless, with grace) and ElasticManager
    (tracker + step deadline + straggler lag) give the same answer at
    every poll."""
    clock = _Clock()
    for mod in PKGS.values():
        monkeypatch.setattr(mod, "time", clock)
    dir_ = str(tmp_path)
    wmod = PKGS[writer]
    writers = {}
    mgrs = {name: mod.ElasticManager(
        max_restarts=1, heartbeat_timeout=20.0, heartbeat_dir=dir_,
        world_size=4, startup_grace=3.0, step_deadline=4.0,
        straggler_lag=8) for name, mod in PKGS.items()}
    seen = []
    for advance, beats in _SCRIPT:
        clock.now += advance
        for r, step in beats.items():
            w = writers.get(r)
            if w is None:
                w = writers[r] = wmod.HeartbeatWriter(dir_, r)
                os.makedirs(dir_, exist_ok=True)
                w._start_ts = clock.time()
            w.set_step(step)
            w._touch()
        got = {}
        for name, mod in PKGS.items():
            got[name] = (mod.stale_ranks(dir_, 20.0, 4, grace=3.0),
                         mod.stale_ranks(dir_, 20.0, 4),
                         mgrs[name].hung_ranks(),
                         mgrs[name].stragglers())
        assert got["port"] == got["ref"], (advance, beats, got)
        seen.append(got["port"])
    # the script visits every class: grace, stragglers, a hung laggard,
    # the frozen gang, and finally stale content
    assert seen[0][0] == [] and seen[0][1] == [3]
    assert any(s[3] for s in seen)
    assert any(s[2] == [1] for s in seen)
    assert seen[-2][2] == [0, 1, 2, 3]
    assert seen[-1][1] == [0, 1, 2, 3]

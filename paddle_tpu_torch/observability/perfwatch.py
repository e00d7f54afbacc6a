"""Perf-regression sentinel + the shared bench result writer
(counterpart of ``paddle_tpu/observability/perfwatch.py``: the same
artifact formats, verdicts and exit codes, so either package's compare
reads the other's files).

Two halves:

* **writer** — :func:`finalize_record` stamps a bench result with the
  ``paddle_tpu.bench/1`` schema and (when ``PADDLE_TPU_BENCH_OUT`` is
  set) appends it as one JSON line to that file.
  ``perfwatch record`` snapshots the *live* perf registry
  (:func:`paddle_tpu_torch.observability.perf.snapshot`) the same way.
* **sentinel** — ``python -m paddle_tpu_torch.observability.perfwatch
  compare old.json new.json`` diffs two artifacts with noise-aware
  thresholds (median-of-k samples, per-metric tolerance bands) and
  exits nonzero naming each regressed metric.  ``--tests`` mode diffs
  two per-test duration artifacts and flags tests that got >2x slower.

Accepted input formats (auto-detected): a perf snapshot (the port's
``paddle_tpu_torch.perf/1`` or the JAX package's ``paddle_tpu.perf/1``),
a bench record or JSONL of records (``paddle_tpu.bench/1`` or
schema-less bench output), a ``BENCH_r*.json`` wrapper (``{"n", "cmd",
"rc", "tail"}`` — records are parsed out of the captured stdout tail),
and a test-times artifact (``paddle_tpu.test_times/1``).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

BENCH_SCHEMA = "paddle_tpu.bench/1"
TEST_TIMES_SCHEMA = "paddle_tpu.test_times/1"

_PERF_SCHEMAS = ("paddle_tpu.perf/", "paddle_tpu_torch.perf/")
_KNOWN_SCHEMAS = _PERF_SCHEMAS + ("paddle_tpu.bench/",
                                  "paddle_tpu.test_times/")


# ---------------------------------------------------------------------------
# Shared writer
# ---------------------------------------------------------------------------

def finalize_record(rec: dict, config: str) -> dict:
    """Stamp a bench result dict with the versioned schema and, when
    ``PADDLE_TPU_BENCH_OUT`` names a file, append it as one JSON line
    (JSONL: one BENCH_CONFIG per line, a whole sweep in one artifact)."""
    rec.setdefault("schema", BENCH_SCHEMA)
    rec.setdefault("config", config)
    rec.setdefault("created_unix", time.time())
    out = os.environ.get("PADDLE_TPU_BENCH_OUT")
    if out:
        try:
            with open(out, "a") as f:
                f.write(json.dumps(rec) + "\n")
        except OSError as e:  # never fail the bench over the artifact
            print(f"perfwatch: cannot write {out}: {e}", file=sys.stderr)
    return rec


# ---------------------------------------------------------------------------
# Validation
# ---------------------------------------------------------------------------

def validate_record(rec) -> list[str]:
    """Problems with one bench-style record ([] = valid).

    Legacy records (schema-less bench output) are accepted when they
    carry the metric/value shape; anything claiming a known schema must
    honor it."""
    if not isinstance(rec, dict):
        return ["record is not an object"]
    schema = rec.get("schema")
    if schema is not None:
        if not isinstance(schema, str) or \
                not schema.startswith(_KNOWN_SCHEMAS):
            return [f"unknown schema {schema!r}"]
        if schema.startswith(_PERF_SCHEMAS):
            return _validate_perf_snapshot(rec)
        if schema.startswith("paddle_tpu.test_times/"):
            return _validate_test_times(rec)
    probs = []
    if "metric" not in rec:
        probs.append("missing 'metric'")
    elif not isinstance(rec["metric"], str):
        probs.append("'metric' is not a string")
    if "value" not in rec:
        probs.append("missing 'value'")
    else:
        v = rec["value"]
        if v is not None and not isinstance(v, (int, float)):
            probs.append("'value' is not numeric or null")
        if v is None and "error" not in rec:
            probs.append("null 'value' without 'error'")
    if schema is not None and not isinstance(rec.get("unit"), str):
        probs.append("missing 'unit'")
    ex = rec.get("extras")
    if ex is not None and not isinstance(ex, dict):
        probs.append("'extras' is not an object")
    return probs


def _validate_perf_snapshot(rec: dict) -> list[str]:
    probs = []
    fields = [("costs", list), ("breakdown", dict), ("mfu", dict)]
    if rec["schema"].startswith("paddle_tpu.perf/"):
        # the JAX package's autobench table; the port runs no autobench,
        # so its snapshots carry none
        fields.append(("kernels", dict))
    for k, ty in fields:
        if not isinstance(rec.get(k), ty):
            probs.append(f"perf snapshot: '{k}' is not {ty.__name__}")
    for c in rec.get("costs") or []:
        if not isinstance(c, dict) or "name" not in c or "key" not in c:
            probs.append("perf snapshot: cost row without name/key")
            break
    return probs


def _validate_test_times(rec: dict) -> list[str]:
    t = rec.get("tests")
    if not isinstance(t, dict):
        return ["test-times artifact: 'tests' is not an object"]
    bad = [k for k, v in t.items() if not isinstance(v, (int, float))]
    if bad:
        return [f"test-times artifact: non-numeric duration for {bad[0]}"]
    return []


def _records_from_tail(tail: str) -> list[dict]:
    """Bench records embedded in a BENCH_r*.json captured-stdout tail."""
    recs = []
    for line in tail.splitlines():
        line = line.strip()
        if not (line.startswith("{") and line.endswith("}")):
            continue
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if isinstance(obj, dict) and "metric" in obj:
            recs.append(obj)
    return recs


def validate_file(path: str) -> list[str]:
    """Problems with a results file ([] = valid); format auto-detected."""
    try:
        text = open(path).read()
    except OSError as e:
        return [f"cannot read {path}: {e}"]
    recs, probs = [], []
    try:
        obj = json.loads(text)
    except ValueError:
        obj = None
    if obj is None:  # JSONL from the shared writer
        for i, line in enumerate(text.splitlines()):
            if not line.strip():
                continue
            try:
                recs.append(json.loads(line))
            except ValueError:
                probs.append(f"line {i + 1}: not JSON")
    elif isinstance(obj, dict) and "tail" in obj and "cmd" in obj:
        tail = str(obj.get("tail") or "")
        recs = _records_from_tail(tail)
        # a tail is a bounded stdout suffix: when capture clipped the
        # head mid-line (first line is not JSON), record loss is
        # expected — only a complete-looking, record-free tail of a
        # successful run is a schema problem
        truncated = bool(tail) and not tail.lstrip().startswith("{")
        if not recs and not truncated and obj.get("rc", 0) == 0:
            probs.append("wrapper tail contains no bench records")
    else:
        recs = [obj]
    for r in recs:
        for p in validate_record(r):
            name = r.get("metric") or r.get("schema") or "?" \
                if isinstance(r, dict) else "?"
            probs.append(f"{name}: {p}")
    return probs


# ---------------------------------------------------------------------------
# Loading + flattening for compare
# ---------------------------------------------------------------------------

_HIGHER_HINTS = ("per_sec", "per_s", "tokens_per", "mfu", "margin",
                 "throughput", "tps", "hits")


def _direction(name: str, unit: str = "") -> str:
    """'higher' if bigger is better for this metric, else 'lower'."""
    s = (name + " " + unit).lower()
    if "/sec" in s or "/s/chip" in s or any(h in s for h in _HIGHER_HINTS):
        return "higher"
    return "lower"


def _median(v):
    if isinstance(v, (list, tuple)):
        nums = [x for x in v if isinstance(x, (int, float))]
        return statistics.median(nums) if nums else None
    return v if isinstance(v, (int, float)) else None


def _flatten(obj: dict) -> dict[str, tuple[float, str]]:
    """{metric_name: (median value, direction)} from any accepted
    artifact.  List-valued leaves (median-of-k recordings) collapse to
    their median here — that is the noise-awareness of the sentinel."""
    out: dict[str, tuple[float, str]] = {}

    def put(name, v, unit=""):
        m = _median(v)
        if m is not None:
            out[name] = (float(m), _direction(name, unit))

    schema = obj.get("schema", "")
    if schema.startswith(_PERF_SCHEMAS):
        for n, v in (obj.get("mfu") or {}).items():
            put(f"mfu.{n}", v)
        for n, ent in (obj.get("breakdown") or {}).items():
            for ph, v in (ent.get("phases") or {}).items():
                put(f"breakdown.{n}.{ph}", v, "seconds")
        for key, ent in (obj.get("kernels") or {}).items():
            win = ent.get("winner")
            win_ms = (ent.get("candidates_ms") or {}).get(win)
            put(f"kernel.{key}.winner_ms", win_ms, "ms")
        for n, d in (obj.get("providers") or {}).items():
            if isinstance(d, dict):
                for k, v in d.items():
                    put(f"{n}.{k}", v)
    elif schema.startswith("paddle_tpu.test_times/"):
        for nodeid, secs in (obj.get("tests") or {}).items():
            put(f"test.{nodeid}", secs, "seconds")
    elif "metric" in obj:  # one bench record (schema'd or legacy)
        unit = str(obj.get("unit", ""))
        put(str(obj["metric"]), obj.get("value"), unit)
        for k, v in (obj.get("extras") or {}).items():
            if isinstance(v, dict):
                put(f"{obj['metric']}.{k}", v.get("value"),
                    str(v.get("unit", "")))
            else:
                put(f"{obj['metric']}.{k}", v)
    return out


def load_result(path: str) -> dict[str, tuple[float, str]]:
    """Flat metric map from a results file (see module docstring for
    the accepted formats)."""
    text = open(path).read()
    try:
        obj = json.loads(text)
    except ValueError:
        obj = None
    merged: dict[str, tuple[float, str]] = {}
    if obj is None:  # JSONL
        for line in text.splitlines():
            if line.strip():
                try:
                    merged.update(_flatten(json.loads(line)))
                except ValueError:
                    pass
    elif isinstance(obj, dict) and "tail" in obj and "cmd" in obj:
        for rec in _records_from_tail(str(obj.get("tail") or "")):
            merged.update(_flatten(rec))
    elif isinstance(obj, dict):
        merged.update(_flatten(obj))
    return merged


# ---------------------------------------------------------------------------
# Compare
# ---------------------------------------------------------------------------

DEFAULT_TOL_PCT = 5.0
# Below this absolute delta a metric never regresses — sub-epsilon
# noise on near-zero readings (a 0.2ms phase) should not fail CI.
_ABS_FLOOR = {"seconds": 1e-4, "ms": 0.05, "": 0.0}


def compare(old: dict[str, tuple[float, str]],
            new: dict[str, tuple[float, str]],
            tol_pct: float = DEFAULT_TOL_PCT,
            tol_map: dict[str, float] | None = None,
            ) -> tuple[int, list[str]]:
    """(exit code, report lines).  0 = no regression; 1 = at least one
    metric regressed beyond its tolerance band, named in the lines."""
    tol_map = tol_map or {}
    lines, regressed = [], []
    common = sorted(set(old) & set(new))
    for name in common:
        ov, direction = old[name]
        nv = new[name][0]
        tol = tol_map.get(name, tol_pct) / 100.0
        delta = nv - ov
        rel = delta / abs(ov) if ov else (0.0 if not delta else float("inf"))
        worse = rel > tol if direction == "lower" else rel < -tol
        floor = 1e-4 if name.startswith(("breakdown.", "test.")) else 0.0
        if worse and abs(delta) > floor:
            regressed.append(name)
            lines.append(
                f"REGRESSION {name}: {ov:.6g} -> {nv:.6g} "
                f"({rel:+.1%}, tol ±{tol:.0%}, {direction}-is-better)")
        else:
            lines.append(f"ok         {name}: {ov:.6g} -> {nv:.6g} "
                         f"({rel:+.1%})")
    for name in sorted(set(old) - set(new)):
        lines.append(f"note       {name}: only in old")
    for name in sorted(set(new) - set(old)):
        lines.append(f"note       {name}: only in new")
    if regressed:
        lines.append(f"{len(regressed)} regressed metric(s): "
                     + ", ".join(regressed))
    elif common:
        lines.append(f"no regressions across {len(common)} metric(s)")
    else:
        lines.append("no comparable metrics")
    return (1 if regressed else 0), lines


def compare_tests(old_path: str, new_path: str,
                  ratio: float = 2.0, floor_s: float = 0.25,
                  ) -> tuple[int, list[str]]:
    """Flag tests that got > `ratio`x slower (and slower by more than
    `floor_s` seconds — sub-second jitter is not a regression)."""
    old = json.load(open(old_path))
    new = json.load(open(new_path))
    for p, rec in ((old_path, old), (new_path, new)):
        probs = _validate_test_times(rec)
        if probs:
            return 2, [f"{p}: {probs[0]}"]
    lines, flagged = [], []
    ot, nt = old["tests"], new["tests"]
    for nodeid in sorted(set(ot) & set(nt)):
        o, n = float(ot[nodeid]), float(nt[nodeid])
        if n > max(ratio * o, o + floor_s):
            flagged.append(nodeid)
            lines.append(f"SLOWER {nodeid}: {o:.2f}s -> {n:.2f}s "
                         f"({n / o if o else float('inf'):.1f}x)")
    tot_o, tot_n = sum(ot.values()), sum(nt.values())
    lines.append(f"wall: {tot_o:.1f}s -> {tot_n:.1f}s over "
                 f"{len(set(ot) & set(nt))} shared test(s)")
    if flagged:
        lines.append(f"{len(flagged)} test(s) >"
                     f"{ratio:g}x slower: " + ", ".join(flagged))
    return (1 if flagged else 0), lines


# ---------------------------------------------------------------------------
# Record
# ---------------------------------------------------------------------------

def record_snapshot(out: str | None, samples: int = 1,
                    interval: float = 0.0) -> dict:
    """Snapshot the live perf registry; with samples>1, numeric leaves
    of mfu/breakdown become value *lists* (compare medianizes them)."""
    from . import perf as _perf

    snaps = []
    for i in range(max(1, samples)):
        if i and interval > 0:
            time.sleep(interval)
        snaps.append(_perf.snapshot())
    snap = snaps[-1]
    if len(snaps) > 1:
        mfu = {}
        for s in snaps:
            for n, v in (s.get("mfu") or {}).items():
                mfu.setdefault(n, []).append(v)
        snap["mfu"] = mfu
        bd: dict[str, dict] = {}
        for s in snaps:
            for n, ent in (s.get("breakdown") or {}).items():
                slot = bd.setdefault(n, {"samples": ent.get("samples", 0),
                                         "phases": {}})
                for ph, v in (ent.get("phases") or {}).items():
                    slot["phases"].setdefault(ph, []).append(v)
        snap["breakdown"] = bd
        snap["samples"] = len(snaps)
    payload = json.dumps(snap, indent=1, sort_keys=True)
    if out:
        tmp = out + ".tmp"
        with open(tmp, "w") as f:
            f.write(payload + "\n")
        os.replace(tmp, out)
    else:
        print(payload)
    return snap


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _parse_tol(items) -> dict[str, float]:
    out = {}
    for it in items or ():
        name, _, pct = it.partition("=")
        try:
            out[name] = float(pct)
        except ValueError:
            raise SystemExit(f"bad --tol entry {it!r} (want name=pct)")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.observability.perfwatch",
        description="perf snapshot recorder + regression sentinel")
    sub = ap.add_subparsers(dest="cmd", required=True)

    rp = sub.add_parser("record", help="snapshot the live perf registry")
    rp.add_argument("-o", "--out", default=None,
                    help="output path (default: stdout)")
    rp.add_argument("--samples", type=int, default=1,
                    help="median-of-k: take k snapshots")
    rp.add_argument("--interval", type=float, default=1.0,
                    help="seconds between snapshots when --samples > 1")

    cp = sub.add_parser("compare", help="diff two result files")
    cp.add_argument("old")
    cp.add_argument("new")
    cp.add_argument("--tol-pct", type=float, default=DEFAULT_TOL_PCT,
                    help="default tolerance band, percent "
                         f"(default {DEFAULT_TOL_PCT:g})")
    cp.add_argument("--tol", action="append", metavar="NAME=PCT",
                    help="per-metric tolerance override (repeatable)")
    cp.add_argument("--tests", action="store_true",
                    help="inputs are test-times artifacts; flag >2x "
                         "slower tests")

    vp = sub.add_parser("validate", help="schema-check result files")
    vp.add_argument("files", nargs="+")

    args = ap.parse_args(argv)
    if args.cmd == "record":
        record_snapshot(args.out, samples=args.samples,
                        interval=args.interval)
        return 0
    if args.cmd == "validate":
        rc = 0
        for p in args.files:
            probs = validate_file(p)
            for prob in probs:
                print(f"{p}: {prob}")
                rc = 1
            if not probs:
                print(f"{p}: ok")
        return rc
    # compare
    try:
        if args.tests:
            rc, lines = compare_tests(args.old, args.new)
        else:
            rc, lines = compare(load_result(args.old),
                                load_result(args.new),
                                tol_pct=args.tol_pct,
                                tol_map=_parse_tol(args.tol))
    except (OSError, ValueError) as e:
        print(f"perfwatch: {e}", file=sys.stderr)
        return 2
    for ln in lines:
        print(ln)
    return rc


if __name__ == "__main__":
    sys.exit(main())

"""The port's perf-regression sentinel and bench record writer
(paddle_tpu_torch/observability/perfwatch.py) and the ``top perf`` pane,
on the CPU: the perfwatch and render_perf cases of
tests/test_perf_plane.py on synthetic artifacts — compare on identical
files, an injected slowdown and an MFU drop (and a widened band that
absorbs both), noise under the absolute floor, the test-times mode,
``record`` over the port's ``perf.snapshot`` (its own schema,
``paddle_tpu_torch.perf/1``), the bench writer, malformed records, and
the perf pane (its winner starred, its empty state). Each compare is
also run through the JAX package's perfwatch on the same files: same
exit code, same report. Left out: test_repo_bench_artifacts_validate
and test_check_bench_schema_script, which read the JAX package's bench
artifacts and scripts.
"""
import json

import pytest

from paddle_tpu.observability import perfwatch as jperfwatch
from paddle_tpu.observability import top as jtop
from paddle_tpu_torch.observability import perf, perfwatch, top

# the JAX package's snapshot schema: the files both packages compare
REF_PERF_SCHEMA = "paddle_tpu.perf/1"


def _snap(mfu_val, device_s):
    return {"schema": REF_PERF_SCHEMA, "created_unix": 0.0,
            "device_kind": "cpu", "peak_flops": 1.0,
            "peak_bytes_per_s": 1.0, "costs": [], "kernels": {},
            "hbm": {}, "providers": {},
            "mfu": {"engine:e0": mfu_val},
            "breakdown": {"engine:e0": {"samples": 3,
                                        "phases": {"device": device_s}}}}


def _both(argv, capsys):
    """(exit code, stdout) of the port's main and of the JAX package's
    on the same argv; they must agree."""
    rc = perfwatch.main(argv)
    out = capsys.readouterr().out
    jrc = jperfwatch.main(argv)
    jout = capsys.readouterr().out
    assert (rc, out) == (jrc, jout)
    return rc, out


def test_compare_identical_exits_zero(tmp_path, capsys):
    p = tmp_path / "a.json"
    p.write_text(json.dumps(_snap(0.40, 0.100)))
    rc, out = _both(["compare", str(p), str(p)], capsys)
    assert rc == 0 and "no regressions" in out


def test_compare_flags_injected_slowdown(tmp_path, capsys):
    old, new = tmp_path / "old.json", tmp_path / "new.json"
    old.write_text(json.dumps(_snap(0.40, 0.100)))
    # ~12% slower device phase, beyond the 5% band and the abs floor
    new.write_text(json.dumps(_snap(0.40, 0.112)))
    rc, out = _both(["compare", str(old), str(new)], capsys)
    assert rc == 1 and "REGRESSION breakdown.engine:e0.device" in out
    # an MFU drop regresses in the higher-is-better direction
    new.write_text(json.dumps(_snap(0.33, 0.100)))
    rc, out = _both(["compare", str(old), str(new)], capsys)
    assert rc == 1 and "REGRESSION mfu.engine:e0" in out
    # a widened tolerance band absorbs both
    new.write_text(json.dumps(_snap(0.33, 0.112)))
    rc, _ = _both(["compare", str(old), str(new), "--tol-pct", "30"],
                  capsys)
    assert rc == 0
    # and a per-metric override absorbs only its own metric
    rc, out = _both(["compare", str(old), str(new), "--tol",
                     "mfu.engine:e0=30"], capsys)
    assert rc == 1 and "REGRESSION breakdown.engine:e0.device" in out \
        and "REGRESSION mfu" not in out


def test_compare_sub_floor_noise_is_not_a_regression(tmp_path, capsys):
    old, new = tmp_path / "old.json", tmp_path / "new.json"
    # 50% relative but 0.05 ms absolute: under the breakdown floor
    old.write_text(json.dumps(_snap(0.40, 0.0001)))
    new.write_text(json.dumps(_snap(0.40, 0.00015)))
    rc, _ = _both(["compare", str(old), str(new)], capsys)
    assert rc == 0


def test_compare_tests_flags_2x_slower(tmp_path, capsys):
    po, pn = tmp_path / "o.json", tmp_path / "n.json"
    po.write_text(json.dumps({"schema": "paddle_tpu.test_times/1",
                              "tests": {"t.py::a": 1.0, "t.py::b": 0.5}}))
    pn.write_text(json.dumps({"schema": "paddle_tpu.test_times/1",
                              "tests": {"t.py::a": 2.6, "t.py::b": 0.6}}))
    rc, out = _both(["compare", "--tests", str(po), str(pn)], capsys)
    assert rc == 1
    assert "SLOWER t.py::a" in out and "t.py::b" not in out
    rc, _ = _both(["compare", "--tests", str(po), str(po)], capsys)
    assert rc == 0
    # a malformed artifact is exit code 2 in both
    pn.write_text(json.dumps({"schema": "paddle_tpu.test_times/1",
                              "tests": {"t.py::a": "slow"}}))
    rc, out = _both(["compare", "--tests", str(po), str(pn)], capsys)
    assert rc == 2 and "non-numeric" in out


def test_compare_bench_records_and_wrappers(tmp_path, capsys):
    """JSONL bench records and a BENCH_r*-style wrapper: the same
    verdicts as the JAX package's."""
    old, new = tmp_path / "old.jsonl", tmp_path / "new.json"
    old.write_text("\n".join(json.dumps(
        {"metric": m, "value": v, "unit": u,
         "extras": {"p99_ms": {"value": 40.0, "unit": "ms"}}})
        for m, v, u in (("decode_tokens_per_sec", 1000.0, "tokens/s"),
                        ("step_ms", 30.0, "ms"))) + "\n")
    tail = "\n".join(["warming up"] + [json.dumps(
        {"metric": m, "value": v, "unit": u,
         "extras": {"p99_ms": {"value": 47.0, "unit": "ms"}}})
        for m, v, u in (("decode_tokens_per_sec", 900.0, "tokens/s"),
                        ("step_ms", 30.5, "ms"))])
    new.write_text(json.dumps({"n": 1, "cmd": "bench", "rc": 0,
                               "tail": tail}))
    rc, out = _both(["compare", str(old), str(new)], capsys)
    assert rc == 1
    assert "REGRESSION decode_tokens_per_sec:" in out
    assert "REGRESSION step_ms.p99_ms" in out
    assert "ok         step_ms:" in out
    # a metric's direction comes from its name: the p99 extra of a
    # per-second metric reads higher-is-better in both packages
    assert "ok         decode_tokens_per_sec.p99_ms" in out
    assert perfwatch.load_result(str(new)) \
        == jperfwatch.load_result(str(new))


def test_record_snapshot_roundtrip(tmp_path):
    perf.mfu_gauge("unit:recorder").set(0.25)
    try:
        out = tmp_path / "perf.json"
        assert perfwatch.main(["record", "-o", str(out), "--samples",
                               "2", "--interval", "0"]) == 0
        snap = json.loads(out.read_text())
        assert snap["schema"] == perf.SNAPSHOT_SCHEMA \
            == "paddle_tpu_torch.perf/1"
        assert snap["samples"] == 2
        assert perfwatch.validate_file(str(out)) == []
        flat = perfwatch.load_result(str(out))
        med, direction = flat["mfu.unit:recorder"]
        assert med == pytest.approx(0.25) and direction == "higher"
        # the port runs no autobench: its snapshot carries no kernel
        # table rather than an empty stand-in
        assert "kernels" not in snap
    finally:
        perf.drop_instance("unit:recorder")


def test_bench_record_writer(tmp_path, monkeypatch):
    out = tmp_path / "bench.jsonl"
    monkeypatch.setenv("PADDLE_TPU_BENCH_OUT", str(out))
    rec = {"metric": "unit_test_ms", "value": 1.5, "unit": "ms"}
    perfwatch.finalize_record(rec, "unit_test")
    assert rec["schema"] == perfwatch.BENCH_SCHEMA \
        == jperfwatch.BENCH_SCHEMA
    assert rec["config"] == "unit_test"
    perfwatch.finalize_record(
        {"metric": "unit_test_ms", "value": 1.4, "unit": "ms"},
        "unit_test")
    assert perfwatch.validate_file(str(out)) == []
    assert jperfwatch.validate_file(str(out)) == []
    lines = out.read_text().splitlines()
    assert len(lines) == 2
    assert all(json.loads(ln)["schema"] == perfwatch.BENCH_SCHEMA
               for ln in lines)


def test_validate_rejects_malformed(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": "paddle_tpu.bench/1",
                               "metric": "m", "value": None}))
    assert perfwatch.validate_file(str(bad))  # null value, no error note
    unknown = tmp_path / "unknown.json"
    unknown.write_text(json.dumps({"schema": "paddle_tpu.wat/9"}))
    assert perfwatch.validate_file(str(unknown))
    # a reference snapshot must carry its kernel table, a port one not
    snap = _snap(0.4, 0.1)
    del snap["kernels"]
    assert perfwatch.validate_record(snap) \
        == jperfwatch.validate_record(snap) != []
    snap["schema"] = perf.SNAPSHOT_SCHEMA
    assert perfwatch.validate_record(snap) == []
    del snap["mfu"]
    assert perfwatch.validate_record(snap)


# ---------------------------------------------------------------------------
# the top perf pane
# ---------------------------------------------------------------------------

def test_render_perf_pane():
    fleet = {"procs": [{"role": "serving", "host": "h", "pid": 1,
                        "summary": {"perf": {
                            "mfu": {"engine:e0": 0.41},
                            "breakdown": {"engine:e0/device": 0.002,
                                          "engine:e0/host": 0.001},
                            "compiles_total": 4,
                            "hbm": {"in_use": 2 ** 30, "limit": 2 ** 31},
                            "kv_cache_bytes": 2 ** 20,
                            "kernel_ms": {"attn[s]/pallas": 1.0,
                                          "attn[s]/xla": 1.5}}}}]}
    text = top.render_perf(fleet)
    assert "engine:e0" in text
    assert "0.41" in text
    assert "device=2.00ms" in text
    assert "pallas=1.000*" in text  # winner starred
    assert text == jtop.render_perf(fleet)
    assert "no perf data" in top.render_perf({"procs": []})
    # a port process reports no autobench margins: the pane has none
    del fleet["procs"][0]["summary"]["perf"]["kernel_ms"]
    text = top.render_perf(fleet)
    assert "kernel margins" not in text
    assert text == jtop.render_perf(fleet)

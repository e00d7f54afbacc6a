"""The port's observability core (paddle_tpu_torch/observability): the
registry, spans bridged into torch.profiler, flight rings, the tenant
meter and the perf plane (H100 peak table, analytic FLOPs equal to the
JAX package's, no device metric without a card)."""
import pytest
import torch

from paddle_tpu.models.gpt import GPTConfig as JConfig
from paddle_tpu.observability import perf as jperf
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.models.gpt import GPTConfig
from paddle_tpu_torch.observability import perf


@pytest.mark.parametrize("tokens,ctx", [(1, 1), (8, 2048), (256, 256)])
def test_analytic_flops_match_jax(tokens, ctx):
    for kw in ({}, dict(hidden_size=2048, num_layers=24, num_heads=16)):
        assert perf.analytic_gpt_flops(GPTConfig(**kw), tokens, ctx) \
            == jperf.analytic_gpt_flops(JConfig(**kw), tokens, ctx)


@pytest.mark.parametrize("name,f32,bf16,bw", [
    ("NVIDIA H100 80GB HBM3", 67e12, 989e12, 3.35e12),
    ("NVIDIA H100 PCIe", 51e12, 756e12, 2.0e12),
    ("NVIDIA H100 NVL", 60e12, 835e12, 3.9e12),
])
def test_card_table(monkeypatch, name, f32, bf16, bw):
    monkeypatch.setattr(perf, "device_kind", lambda: name)
    assert perf.chip_peak_flops() == (f32, name)
    assert perf.chip_peak_flops("bfloat16") == (bf16, name)
    assert perf.chip_peak_bytes_per_s() == (bw, name)
    assert perf.mfu(f32, 1.0) == pytest.approx(1.0)


def test_no_card_means_no_device_metric():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert perf.chip_peak_flops() == (None, "cpu")
    assert perf.mfu(1e12, 1.0) == 0.0
    snap = perf.snapshot()
    assert snap["device_kind"] == "cpu" and snap["peak_flops"] is None
    assert snap["hbm"] == {"in_use": 0.0, "limit": 0.0, "peak": 0.0}


def test_spans_enter_the_torch_profiler():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with obs.span("port.test_span", attr=1):
            torch.ones(4).sum()
    names = {e.key for e in prof.key_averages()}
    assert "port.test_span" in names
    sp = obs.TRACER.spans()[-1]
    assert sp.name == "port.test_span" and sp.attrs == {"attr": 1}


def test_registry_flight_and_meter():
    c = obs.counter("paddle_tpu_port_test_total", "test", ["k"])
    c.labels(k="a").inc(2)
    assert 'paddle_tpu_port_test_total{k="a"} 2' in obs.prometheus_text()
    with pytest.raises(obs.registry.MetricError):
        obs.counter("bad-name")
    ev = obs.flight.record("serving", "port_test", trace_id="t1", n=3)
    assert obs.flight.timeline("t1")[-1] is ev
    obs.METER.note_submitted("tenant-x", 1, 7)
    rep = obs.METER.report()["tenants"]["tenant-x/1"]
    assert rep["tokens_in"] >= 7


def test_breakdown_and_costs():
    perf.register_cost("serving:t", "decode[slots=8,pages=4]", 123.0)
    assert perf.costs()[("serving:t", "decode[slots=8,pages=4]")][
        "flops"] == 123.0
    perf.record_breakdown("engine:t", {"host": 0.1, "device": 0.2})
    assert perf.breakdowns()["engine:t"]["phases"]["device"] == 0.2
    s = perf.StepSampler("x")
    old = perf.sampling_every()
    perf.set_every(2)
    try:
        assert [s.tick() for _ in range(4)] == [False, True, False, True]
    finally:
        perf.set_every(old)

"""Performance observability plane: cost registry, MFU, step attribution.

Views over the one metrics registry:

* **cost registry** — per-(name, key) FLOPs of the programs we run,
  registered once per compile bucket from :func:`analytic_gpt_flops`
  (eager PyTorch has no compiler cost analysis to read), exposed as
  ``paddle_tpu_perf_flops`` gauges.
* **step-time decomposition** — :class:`StepSampler` gates a sampled
  profile of one step in ``PADDLE_TPU_PERFWATCH_EVERY`` (default 50;
  0 disables).  On a sampled step the caller fences phase boundaries
  with a CUDA synchronise and reports host / dispatch / device /
  transfer seconds via :func:`record_breakdown`.
* **MFU accounting** — :func:`chip_peak_flops` resolves the card's
  data-sheet peak from ``torch.cuda.get_device_name()`` and
  :func:`mfu` converts achieved FLOP/s to model-flops-utilisation.
  With no card the peak is unknown and MFU reads 0: a CPU run never
  reports a device utilisation.
"""
from __future__ import annotations

import os
import sys
import threading
import time
import weakref

from . import flight as _flight
from . import registry as _obs

__all__ = [
    "SNAPSHOT_SCHEMA", "StepSampler", "analytic_gpt_flops",
    "bert_train_flops_per_step", "breakdowns", "chip_peak_bytes_per_s", "chip_peak_flops", "costs",
    "device_kind", "drop_instance", "gpt_train_flops_per_step",
    "kv_cache_gauge", "mfu", "mfu_gauge",
    "note_compile_seconds", "record_breakdown", "register_cost",
    "resnet_train_flops_per_step",
    "register_provider", "sampling_every", "set_every", "snapshot",
    "weak_provider",
]

SNAPSHOT_SCHEMA = "paddle_tpu_torch.perf/1"

# (device-name substring, dense peak FLOP/s by dtype, HBM bytes/s) from
# NVIDIA's H100 data sheet; first match wins, so specific names first.
# float32 is the rate outside the tensor cores (the port's f32 path
# runs with TF32 off).
_CARDS = [
    ("H100 PCIe", {"bfloat16": 756e12, "float32": 51e12}, 2.0e12),
    ("H100 NVL", {"bfloat16": 835e12, "float32": 60e12}, 3.9e12),
    ("H100", {"bfloat16": 989e12, "float32": 67e12}, 3.35e12),
]


def device_kind() -> str:
    """The CUDA card's name, or "cpu" when there is none."""
    import torch
    if not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name(0)


def _card(kind: str):
    for sub, peaks, bw in _CARDS:
        if sub in kind:
            return peaks, bw
    return None, None


def chip_peak_flops(dtype: str = "float32") -> tuple[float | None, str]:
    """(data-sheet peak FLOP/s for `dtype`, device name); None when the
    card is not in the table (or there is no card)."""
    kind = device_kind()
    peaks, _ = _card(kind)
    return (peaks.get(dtype) if peaks else None), kind


def chip_peak_bytes_per_s() -> tuple[float | None, str]:
    """(data-sheet HBM bytes/s, device name); None when unknown."""
    kind = device_kind()
    return _card(kind)[1], kind


def mfu(flops: float, seconds: float, dtype: str = "float32") -> float:
    """Model-flops-utilisation of `flops` model FLOPs in `seconds`
    against the card's `dtype` peak (0 when the peak is unknown)."""
    if seconds <= 0 or flops <= 0:
        return 0.0
    peak, _ = chip_peak_flops(dtype)
    if not peak:
        return 0.0
    return float(flops) / seconds / peak


def analytic_gpt_flops(cfg, tokens: int, ctx: int) -> float:
    """Matmul-only forward FLOPs for `tokens` new tokens of a GPT block
    stack at context length `ctx` (qkv+proj+mlp+attn matmuls + the LM
    head, no norms/softmax)."""
    H = int(getattr(cfg, "hidden_size", 0))
    L = int(getattr(cfg, "num_layers", 0))
    F = int(getattr(cfg, "intermediate_size", 4 * H) or 4 * H)
    V = int(getattr(cfg, "vocab_size", 0))
    if not (H and L):
        return 0.0
    per_layer = (
        3 * 2 * H * H        # qkv projections
        + 2 * H * H          # output projection
        + 2 * 2 * ctx * H    # qk^T and attn@v
        + 2 * H * F + 2 * F * H  # mlp
    )
    return float(tokens) * (L * per_layer + 2 * H * V)


def gpt_train_flops_per_step(cfg, batch: int, seq: int) -> float:
    """Matmul-only analytic FLOPs of one train step, forward + 2x
    backward (bench.py's gpt_train_flops_per_step, the MFU convention):
    every token attends over the full sequence length."""
    return 3 * analytic_gpt_flops(cfg, batch * seq, seq)


def bert_train_flops_per_step(cfg, batch: int, seq: int,
                              n_pred: int | None = None) -> int:
    """Matmul-only analytic FLOPs of one BERT pretrain step, forward + 2x
    backward (bench.py's bert_train_flops_per_step, so an MFU is
    comparable with the reference's arithmetic): the dense projections,
    the attention score and context products, the MLM transform and
    vocab projection over the `n_pred` masked positions a sequence that
    reach it (None: all `seq` positions) and the NSP head; elementwise
    and norm FLOPs are ignored."""
    H, L, V = cfg.hidden_size, cfg.num_hidden_layers, cfg.vocab_size
    I = cfg.intermediate_size
    tokens = batch * seq
    per_layer = (
        2 * H * (3 * H)          # qkv proj
        + 2 * H * H              # attention out proj
        + 2 * 2 * seq * H        # scores QK^T + context PV (per token)
        + 2 * H * I + 2 * I * H  # ffn up + down
    )
    pred_tokens = batch * (n_pred if n_pred is not None else seq)
    mlm_head = 2 * H * H + 2 * H * V    # transform + vocab proj
    fwd = tokens * L * per_layer + pred_tokens * mlm_head \
        + batch * (2 * H * 2)
    return 3 * fwd


def resnet_train_flops_per_step(batch: int) -> int:
    """FLOPs of one ResNet-50 train step at 224 x 224 (bench.py's
    resnet_train_flops_per_step): the convolutions and the fc, 2 FLOPs a
    multiply-add (8.18 GFLOP an image forward), times 3 for forward, dX
    and dW; batch norm, pooling and elementwise are ignored."""
    blocks = [(3, 64), (4, 128), (6, 256), (3, 512)]
    f = 2 * 7 * 7 * 3 * 64 * 112 * 112          # stem
    cin, hw = 64, 56 * 56
    for si, (n, cmid) in enumerate(blocks):
        cout = cmid * 4
        for bi in range(n):
            stride = 2 if (bi == 0 and si > 0) else 1
            hw2 = hw // (stride * stride)
            f += 2 * cin * cmid * hw            # 1x1 reduce
            f += 2 * 9 * cmid * cmid * hw2      # 3x3
            f += 2 * cmid * cout * hw2          # 1x1 expand
            if bi == 0:
                f += 2 * cin * cout * hw2       # downsample shortcut
            cin, hw = cout, hw2
    f += 2 * 2048 * 1000                        # fc
    return 3 * f * batch


# ---------------------------------------------------------------------------
# Metric series
# ---------------------------------------------------------------------------

_FLOPS = _obs.gauge(
    "paddle_tpu_perf_flops",
    "analytic FLOPs per invocation of a program bucket", ["name", "key"])
_MFU = _obs.gauge(
    "paddle_tpu_perf_mfu",
    "live model-flops-utilisation (achieved/peak) per instrumented loop",
    ["name"])
_BREAKDOWN = _obs.gauge(
    "paddle_tpu_perf_step_breakdown_seconds",
    "last sampled step-time decomposition (host/dispatch/device/transfer)",
    ["name", "phase"])
# first calls pay kernel builds and allocator warm-up: seconds, not ms
_COMPILE_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                    30.0, 60.0, 120.0, 300.0)
_COMPILE_H = _obs.histogram(
    "paddle_tpu_perf_compile_seconds",
    "first-call wall time per program bucket", ["site"],
    buckets=_COMPILE_BUCKETS)
_HBM = _obs.gauge(
    "paddle_tpu_perf_hbm_bytes",
    "device memory stats from torch.cuda (0 without an initialised card)",
    ["kind"])
_KV_BYTES = _obs.gauge(
    "paddle_tpu_perf_kv_cache_bytes",
    "bytes held by a serving engine's paged KV cache", ["engine"])


def _hbm_stat(stat: str) -> float:
    """Allocator statistics of card 0. Reads nothing (0.0) unless CUDA
    is already initialised: exposition must never create a context, nor
    import torch into a process that has not (a PS shard's scrape)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return 0.0
    if stat == "limit":
        return float(torch.cuda.mem_get_info(0)[1])
    key = {"in_use": "allocated_bytes.all.current",
           "peak": "allocated_bytes.all.peak"}[stat]
    return float(torch.cuda.memory_stats(0).get(key, 0))


for _k in ("in_use", "limit", "peak"):
    _HBM.labels(kind=_k).set_function(lambda k=_k: _hbm_stat(k))


def kv_cache_gauge(engine_id: str):
    """Per-engine KV-cache-bytes gauge child (engine sets a weakref
    function on it; dropped with the engine's other series)."""
    return _KV_BYTES.labels(engine=engine_id)


def mfu_gauge(name: str):
    """Labeled MFU gauge child for `name` (callers may set_function)."""
    return _MFU.labels(name=name)


# ---------------------------------------------------------------------------
# Cost registry
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
_COSTS: dict[tuple[str, str], dict] = {}
_BREAKDOWNS: dict[str, dict] = {}
# name -> zero-arg callable returning a JSON-safe dict merged into
# snapshot()["providers"].  Callables must be cheap and must not block.
_PROVIDERS: dict[str, object] = {}


def register_cost(name: str, key: str, flops: float | None) -> float | None:
    """Record the per-invocation analytic FLOPs of program (name, key)."""
    fl = float(flops) if flops and flops > 0 else None
    with _LOCK:
        _COSTS[(name, key)] = {"flops": fl, "source": "analytic"}
    if fl is not None:
        _FLOPS.labels(name=name, key=key).set(fl)
    return fl


def costs() -> dict[tuple[str, str], dict]:
    with _LOCK:
        return {k: dict(v) for k, v in _COSTS.items()}


# ---------------------------------------------------------------------------
# Step sampling + breakdown
# ---------------------------------------------------------------------------

def _env_every() -> int:
    try:
        return max(0, int(os.environ.get("PADDLE_TPU_PERFWATCH_EVERY", "50")))
    except ValueError:
        return 50


_EVERY = _env_every()


def sampling_every() -> int:
    """Current sampling cadence (every Nth step; 0 = off)."""
    return _EVERY


def set_every(n: int) -> None:
    """Override the sampling cadence at runtime (bench A/B/A, tests)."""
    global _EVERY
    _EVERY = max(0, int(n))


class StepSampler:
    """Decides which steps pay for a fenced profile.

    ``tick()`` returns True on every Nth call where N is the *current*
    module cadence (so ``set_every`` toggles live samplers too).  The
    first tick never samples: step 1 usually builds kernels.
    """

    __slots__ = ("name", "_n")

    def __init__(self, name: str):
        self.name = name
        self._n = 0

    def tick(self) -> bool:
        every = _EVERY
        if every <= 0:
            return False
        self._n += 1
        return self._n % every == 0


def record_breakdown(name: str, phases: dict[str, float]) -> None:
    """Report one sampled step's phase decomposition (seconds)."""
    now = time.time()
    with _LOCK:
        ent = _BREAKDOWNS.setdefault(name, {"samples": 0, "phases": {}})
        ent["samples"] += 1
        ent["time"] = now
        for ph, v in phases.items():
            ent["phases"][ph] = float(v)
    for ph, v in phases.items():
        _BREAKDOWN.labels(name=name, phase=ph).set(float(v))
    _flight.record("perf", "sample", name=name,
                   **{k: round(float(v), 6) for k, v in phases.items()})


def breakdowns() -> dict[str, dict]:
    with _LOCK:
        return {k: {"samples": v["samples"], "time": v.get("time"),
                    "phases": dict(v["phases"])}
                for k, v in _BREAKDOWNS.items()}


def note_compile_seconds(site: str, seconds: float) -> None:
    """Record one bucket's first-call wall time."""
    _COMPILE_H.labels(site=site).observe(float(seconds))


# ---------------------------------------------------------------------------
# Providers + snapshot
# ---------------------------------------------------------------------------

def register_provider(name: str, fn) -> None:
    """Register a cheap zero-arg callable contributing a dict to
    snapshot()["providers"][name].  Re-registering replaces."""
    with _LOCK:
        _PROVIDERS[name] = fn


def unregister_provider(name: str) -> None:
    with _LOCK:
        _PROVIDERS.pop(name, None)


def drop_instance(name: str, engine_id: str | None = None) -> None:
    """Drop the per-instance series for a garbage-collected owner."""
    unregister_provider(name)
    _MFU.remove_matching(name=name)
    _BREAKDOWN.remove_matching(name=name)
    if engine_id is not None:
        _KV_BYTES.remove_matching(engine=engine_id)
    with _LOCK:
        _BREAKDOWNS.pop(name, None)


def snapshot() -> dict:
    """Schema-versioned JSON-safe dump of the whole perf plane."""
    peak, kind = chip_peak_flops()
    bw, _ = chip_peak_bytes_per_s()
    with _LOCK:
        providers = dict(_PROVIDERS)
    prov_out = {}
    for name, fn in providers.items():  # outside _LOCK: fns may lock
        try:
            d = fn()
            if isinstance(d, dict):
                prov_out[name] = d
        except Exception:
            pass
    return {
        "schema": SNAPSHOT_SCHEMA,
        "created_unix": time.time(),
        "device_kind": kind,
        "peak_flops": peak,
        "peak_bytes_per_s": bw,
        "costs": [{"name": n, "key": k, **c}
                  for (n, k), c in sorted(costs().items())],
        "breakdown": breakdowns(),
        "hbm": {k: _hbm_stat(k) for k in ("in_use", "limit", "peak")},
        "providers": prov_out,
    }


def weak_provider(obj, method_name: str):
    """A provider callable holding only a weakref to `obj`."""
    ref = weakref.ref(obj)

    def call():
        o = ref()
        if o is None:
            return {}
        return getattr(o, method_name)()
    return call

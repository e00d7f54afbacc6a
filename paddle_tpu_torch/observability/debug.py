"""Postmortem debug bundles — one atomic directory of crash evidence
(counterpart of ``paddle_tpu/observability/debug.py``; the file layout
and the manifest are the same, so each package's ``load_bundle`` reads
the other's bundles).

A bundle freezes every observability surface of one process at one
instant: the metrics registry (Prometheus text AND the JSON dump
format), the trace ring as Chrome ``trace_event`` JSON, the flight
recorder rings, environment/config/version info, and the in-flight
request table of whichever engines registered a provider. Bundles are
written:

  * on watchdog fire (``observability.watchdog``);
  * on unhandled exceptions (``install_crash_hooks`` — ``sys`` and
    ``threading`` excepthooks, chained, gated on
    ``PADDLE_TPU_DEBUG_DIR``);
  * on the SIGTERM dump hook (``observability.__init__`` — the path a
    supervisor uses to stop a process);
  * on demand via the ``debug_dump`` verb of the serving frontend
    (``dump_verb`` is the handler), and directly via ``write_bundle()``.

Crash consistency mirrors the checkpoint store: files are written
into a hidden temp directory, ``MANIFEST.json`` (CRC32 + size per
file) lands last, and one ``os.rename`` of the directory is the commit
point — a torn bundle is never visible under its final name.
``load_bundle`` re-verifies every CRC.

Layout (under ``PADDLE_TPU_DEBUG_DIR``):

    bundle_<host>_<pid>_<ms>_<seq>/
      MANIFEST.json   reason, host, pid, time, {file: {crc32, bytes}}
      metrics.prom    Prometheus text exposition
      metrics.json    registry JSON dump (aggregatable across ranks)
      trace.json      Chrome trace_event export of the span ring
      flight.json     flight-recorder snapshot (per-tier event rings)
      env.json        PADDLE_*/TORCH_*/CUDA_* env, argv, versions
      requests.json   per-provider in-flight request tables

``python -m paddle_tpu_torch.observability.registry <dir>`` lists the
bundles of a multi-rank job and merges their ``metrics.json`` into the
job aggregate (``aggregate_with_bundles``).
"""
from __future__ import annotations

import itertools
import json
import os
import platform
import socket
import sys
import threading
import time
import zlib

from . import flight as _flight
from . import registry as _registry
from . import tracing as _tracing

__all__ = ["BundleError", "BUNDLE_PREFIX", "collect", "write_bundle",
           "dump_verb", "load_bundle", "list_bundles",
           "aggregate_with_bundles", "register_requests_provider",
           "unregister_requests_provider", "install_crash_hooks"]

BUNDLE_PREFIX = "bundle_"
BUNDLE_VERSION = 1

_seq = itertools.count()


class BundleError(ValueError):
    """Missing/corrupt bundle file (CRC or manifest mismatch)."""


# ---------------------------------------------------------------------------
# in-flight request providers (the serving engine registers one per
# instance; anything owning request state can too)
# ---------------------------------------------------------------------------

_providers: dict[str, object] = {}
_providers_lock = threading.Lock()


def register_requests_provider(key: str, fn):
    """``fn()`` -> JSON-safe summary of the owner's in-flight work
    (or None once the owner is gone — the provider is then dropped).
    Providers run inside ``collect`` and must never block on the locks
    a wedged tier might hold."""
    with _providers_lock:
        _providers[key] = fn


def unregister_requests_provider(key: str):
    with _providers_lock:
        _providers.pop(key, None)


def _requests_snapshot() -> dict:
    with _providers_lock:
        items = list(_providers.items())
    out, dead = {}, []
    for key, fn in items:
        try:
            v = fn()
        except Exception as e:
            out[key] = {"error": f"{type(e).__name__}: {e}"}
            continue
        if v is None:
            dead.append(key)
        else:
            out[key] = v
    for key in dead:
        unregister_requests_provider(key)
    return out


# ---------------------------------------------------------------------------
# collection
# ---------------------------------------------------------------------------

_ENV_PREFIXES = ("PADDLE_", "TORCH_", "PYTORCH_", "CUDA_", "NCCL_",
                 "FLAGS_", "BENCH_", "TRAINING_ROLE", "POD_IP")
# never let credentials (e.g. PADDLE_PS_SECRET, the HMAC shared
# secret) land in a bundle that gets copied around or returned over
# the wire by the debug_dump verb
_SECRET_MARKERS = ("SECRET", "TOKEN", "PASSWORD", "CREDENTIAL")


def _env_value(key: str, val: str) -> str:
    up = key.upper()
    if any(m in up for m in _SECRET_MARKERS) or up.endswith("_KEY"):
        return "<redacted>"
    return val


def _versions() -> dict:
    """Python, torch (and the CUDA it was built for), numpy, and the
    card's name when one is present. Reads no device state beyond the
    name: a bundle is written while a step may be wedged on the card."""
    import numpy
    import torch
    versions: dict[str, object] = {
        "python": sys.version, "torch": torch.__version__,
        "cuda": torch.version.cuda, "numpy": numpy.__version__,
        "device": None}
    try:
        if torch.cuda.is_available():
            versions["device"] = torch.cuda.get_device_name(0)
    except Exception:
        pass
    return versions


def _env_info() -> dict:
    return {"argv": list(sys.argv), "cwd": os.getcwd(),
            "platform": platform.platform(),
            "env": {k: _env_value(k, v)
                    for k, v in sorted(os.environ.items())
                    if k.startswith(_ENV_PREFIXES)},
            "versions": _versions()}


def collect(reason: str = "manual", extra=None) -> dict:
    """Gather every section of a bundle in memory (JSON-safe — this is
    exactly what the ``debug_dump`` verb returns over the wire)."""
    out = {
        "version": BUNDLE_VERSION, "reason": reason,
        "host": socket.gethostname(), "pid": os.getpid(),
        "time": time.time(), "monotonic": time.monotonic(),
        "metrics_text": _registry.prometheus_text(),
        "metrics": _registry.to_dict(),
        "trace": _tracing.TRACER.export_chrome_trace(),
        "flight": _flight.RECORDER.snapshot(),
        "env": _env_info(),
        "requests": _requests_snapshot(),
    }
    if extra is not None:
        out["extra"] = extra
    return out


# ---------------------------------------------------------------------------
# write / read
# ---------------------------------------------------------------------------

def _bundle_files(bundle: dict) -> dict[str, bytes]:
    def j(obj) -> bytes:
        return json.dumps(obj, indent=1, sort_keys=True).encode("utf-8")

    files = {
        "metrics.prom": bundle["metrics_text"].encode("utf-8"),
        "metrics.json": j(bundle["metrics"]),
        "trace.json": j(bundle["trace"]),
        "flight.json": j(bundle["flight"]),
        "env.json": j(bundle["env"]),
        "requests.json": j(bundle["requests"]),
    }
    if bundle.get("extra") is not None:
        # caller-supplied context (e.g. the launcher's crash-loop
        # postmortem naming the flapping rank) must survive to disk
        files["extra.json"] = j(bundle["extra"])
    return files


def write_bundle(dir_: str | None = None, reason: str = "manual",
                 extra=None, bundle: dict | None = None) -> str:
    """Write one atomic bundle directory; returns its path. The
    directory rename is the commit point — a crash mid-write leaves
    only a hidden ``.tmp_*`` turd, never a half bundle."""
    d = dir_ or os.environ.get("PADDLE_TPU_DEBUG_DIR")
    if not d:
        raise ValueError("no bundle directory: pass dir_ or set "
                         "PADDLE_TPU_DEBUG_DIR")
    if bundle is None:
        bundle = collect(reason=reason, extra=extra)
    files = _bundle_files(bundle)
    name = (f"{BUNDLE_PREFIX}{bundle['host']}_{bundle['pid']}_"
            f"{int(bundle['time'] * 1000)}_{next(_seq)}")
    tmp = os.path.join(d, f".tmp_{name}")
    os.makedirs(tmp, exist_ok=True)
    manifest = {"version": BUNDLE_VERSION, "reason": bundle["reason"],
                "host": bundle["host"], "pid": bundle["pid"],
                "time": bundle["time"],
                "files": {fn: {"crc32": zlib.crc32(data),
                               "bytes": len(data)}
                          for fn, data in files.items()}}
    for fn, data in files.items():
        with open(os.path.join(tmp, fn), "wb") as f:
            f.write(data)
    with open(os.path.join(tmp, "MANIFEST.json"), "w",
              encoding="utf-8") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    final = os.path.join(d, name)
    os.rename(tmp, final)
    # bundle writes show up on the fleet dashboard (path + reason)
    # when a telemetry agent is armed; silent no-op otherwise
    from . import agent as _agent
    _agent.publish_event("bundle", reason=bundle["reason"],
                         path=final)
    return final


def dump_verb(req: dict | None = None,
              reason: str = "debug_dump") -> dict:
    """Handler behind the serving frontend's `debug_dump` verb: collect a bundle, persist it into the OPERATOR-configured
    PADDLE_TPU_DEBUG_DIR (``req['write']=False`` skips disk), and
    return the in-memory bundle + its path. The destination is
    deliberately NOT wire-controlled — a network peer must never pick
    a server-side filesystem path to write to."""
    req = req or {}
    bundle = collect(reason=reason)
    path = None
    if req.get("write", True):
        d = os.environ.get("PADDLE_TPU_DEBUG_DIR")
        if d:
            try:
                path = write_bundle(d, bundle=bundle)
            except Exception as e:
                bundle["write_error"] = f"{type(e).__name__}: {e}"
    bundle["path"] = path
    return bundle


def load_bundle(path: str, verify: bool = True) -> dict:
    """Read a bundle back; ``verify`` re-checks every CRC32 (raises
    BundleError on mismatch/missing files). JSON files are parsed,
    ``metrics.prom`` comes back as text."""
    mpath = os.path.join(path, "MANIFEST.json")
    try:
        with open(mpath, encoding="utf-8") as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise BundleError(f"unreadable manifest {mpath}: {e}") from None
    files = {}
    for fn, info in manifest.get("files", {}).items():
        fpath = os.path.join(path, fn)
        try:
            with open(fpath, "rb") as f:
                data = f.read()
        except OSError as e:
            raise BundleError(f"missing bundle file {fpath}: {e}") \
                from None
        if verify and zlib.crc32(data) != info.get("crc32"):
            raise BundleError(f"crc mismatch in {fpath}")
        if fn.endswith(".json"):
            files[fn] = json.loads(data.decode("utf-8"))
        else:
            files[fn] = data.decode("utf-8")
    return {"path": path, "manifest": manifest, "files": files}


# ---------------------------------------------------------------------------
# multi-rank listing / aggregation
# ---------------------------------------------------------------------------

def _scan_bundles(dir_: str) -> list[tuple[dict, dict | None]]:
    """One verified read per bundle: (summary, loaded-or-None)."""
    out = []
    try:
        names = sorted(os.listdir(dir_))
    except OSError:
        return out
    for name in names:
        path = os.path.join(dir_, name)
        if not name.startswith(BUNDLE_PREFIX) or not os.path.isdir(path):
            continue
        rec = {"path": path, "name": name, "valid": False}
        loaded = None
        try:
            loaded = load_bundle(path, verify=True)
            m = loaded["manifest"]
            rec.update(reason=m.get("reason"), host=m.get("host"),
                       pid=m.get("pid"), time=m.get("time"),
                       valid=True)
        except BundleError as e:
            rec["error"] = str(e)
        out.append((rec, loaded))
    out.sort(key=lambda rb: rb[0].get("time") or 0)
    return out


def list_bundles(dir_: str) -> list[dict]:
    """Summaries of every committed bundle under ``dir_`` (sorted by
    time): reason/host/pid/time plus a CRC verification verdict."""
    return [rec for rec, _b in _scan_bundles(dir_)]


def aggregate_with_bundles(dir_: str) -> dict:
    """Job-level merge: the per-process ``metrics_*.json`` dumps PLUS
    bundle metrics, aggregated with the registry rules (counters and
    histograms sum, gauges keep newest), and a ``bundles`` listing
    when any exist. Registry snapshots from the SAME process overlap
    (a watchdog-fire bundle, a later SIGTERM bundle, the exit-time
    metrics dump all cover one counter history), so only the NEWEST
    snapshot per (host, pid) contributes — summing them would
    double-count that rank."""
    # (host, pid) -> (time, metrics dump); newest snapshot wins. A
    # dump with no process identity gets a unique key and always
    # contributes.
    newest: dict[tuple, tuple[float, dict]] = {}

    def offer(key, t, dump):
        if key[1] is None:
            key = (key[0], object())
        cur = newest.get(key)
        if cur is None or t >= cur[0]:
            newest[key] = (t, dump)

    try:
        names = sorted(os.listdir(dir_))
    except OSError:
        names = []
    for fn in names:
        if fn.startswith("metrics_") and fn.endswith(".json"):
            try:
                with open(os.path.join(dir_, fn),
                          encoding="utf-8") as f:
                    d = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue
            offer((d.get("host"), d.get("pid")), d.get("time") or 0, d)
    scanned = _scan_bundles(dir_)
    for rec, loaded in scanned:
        if not rec["valid"] or loaded is None:
            continue
        m = loaded["files"].get("metrics.json")
        if m is not None:
            offer((rec.get("host"), rec.get("pid")),
                  rec.get("time") or 0, m)
    agg = _registry.aggregate_dumps([d for _t, d in newest.values()])
    if scanned:
        agg["bundles"] = [
            {k: rec.get(k) for k in ("name", "reason", "host", "pid",
                                     "time", "valid", "error")
             if k in rec} for rec, _b in scanned]
    return agg


# ---------------------------------------------------------------------------
# crash hooks (unhandled exceptions)
# ---------------------------------------------------------------------------

_hooks_installed = False


def try_write_bundle(reason: str, dir_: str | None = None) -> str | None:
    """Best-effort bundle write: None when no debug dir is configured
    (``dir_`` or ``PADDLE_TPU_DEBUG_DIR``) or the write fails — the
    crash/stall/teardown paths that call this must never be masked by a
    failing dump."""
    if not (dir_ or os.environ.get("PADDLE_TPU_DEBUG_DIR")):
        return None
    try:
        return write_bundle(dir_, reason=reason)
    except Exception:
        return None


def arm_hard_exit(code: int = 143, grace_s: float = 10.0,
                  name: str = "postmortem-hard-exit") -> threading.Thread:
    """Arm a daemon thread that ``os._exit(code)``s after ``grace_s`` —
    bounds the cost of a dump or signal handler that can never finish
    (wedged main thread, a non-reentrant lock held by the interrupted
    frame). Whatever evidence made it to disk stands."""
    def _escalate():
        time.sleep(grace_s)
        os._exit(code)

    t = threading.Thread(target=_escalate, daemon=True, name=name)
    t.start()
    return t


def install_crash_hooks():
    """Chain bundle writes onto sys.excepthook and threading.excepthook
    (idempotent; KeyboardInterrupt/SystemExit excluded). Gated at dump
    time on PADDLE_TPU_DEBUG_DIR so installing is always safe."""
    global _hooks_installed
    if _hooks_installed:
        return
    _hooks_installed = True

    prev_sys = sys.excepthook

    def _sys_hook(exc_type, exc, tb):
        if isinstance(exc, Exception):
            try_write_bundle(f"excepthook:{exc_type.__name__}")
        prev_sys(exc_type, exc, tb)

    sys.excepthook = _sys_hook

    prev_thread = threading.excepthook

    def _thread_hook(args):
        if isinstance(args.exc_value, Exception):
            try_write_bundle(
                f"thread-excepthook:{args.exc_type.__name__}")
        prev_thread(args)

    threading.excepthook = _thread_hook

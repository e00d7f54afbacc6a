"""Build the CUDA sources under ``ops/csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface (no PyTorch headers, so a
build takes seconds). All sources are compiled at once, one ``nvcc``
process each, the first time any kernel is needed; the result lands in
``ops/build/`` under a name that carries a hash of the source, the
shared ``csrc/*.cuh`` headers and the flags, so an edited source is
rebuilt and an unchanged one is reused. Processes that share the
checkout (the ranks of a data-parallel run) build under one file lock
(``build/.lock``): the first builds, the others wait and load its
libraries.

A failed build raises with the compiler's output. There is no fallback:
a CUDA tensor either reaches its kernel or the call raises.

The launch counters live here too: each kernel wrapper calls
``note_launch(name)`` right after its kernel launched, and nowhere else.
Route counters ``<name>.<route>`` sit beside them: a kernel with several
designs counts each launch under its route as well.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["SOURCES", "build_all", "library", "function", "note_launch",
           "launch_counts", "reset_launch_counts", "nvcc_path", "build_log",
           "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("paged_attention", "fused_block", "flash_attention",
           "layer_norm", "fused_residual", "fused_ffn")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], object] = {}
_build_log: dict[str, str] = {}

_count_lock = threading.Lock()
_counts: dict[str, int] = {}


def note_launch(name: str) -> None:
    with _count_lock:
        _counts[name] = _counts.get(name, 0) + 1


def launch_counts() -> dict[str, int]:
    with _count_lock:
        return dict(_counts)


def reset_launch_counts() -> None:
    with _count_lock:
        _counts.clear()


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME, /usr/local/cuda, PATH): the CUDA "
            "kernels of paddle_tpu_torch cannot be built on this host")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):   # shared by the sources
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, float]:
    """Compile every source that has no up-to-date library, all nvcc
    processes running at once. Returns {name: seconds} of this call
    (0.0 for a library that was already built); raises on failure."""
    with _lock:
        return _build_locked()


def _build_locked() -> dict[str, float]:
    secs = {n: 0.0 for n in SOURCES}
    if all(_target(n).exists() for n in SOURCES):
        return secs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)   # another process may be building
        todo = {n: _target(n) for n in SOURCES if not _target(n).exists()}
        if todo:
            _compile(todo, secs)
    return secs


def _compile(todo: dict, secs: dict) -> None:
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for name, out in todo.items():
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        _build_log[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc rc {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def build_log() -> dict[str, str]:
    """nvcc's output (ptxas register/spill report) of this process's
    builds, by source name."""
    return dict(_build_log)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _build_locked()
            lib = _libs[name] = ctypes.CDLL(str(_target(name)))
        return lib


def function(name: str, symbol: str, n_ptr: int, n_int: int, tail=()):
    """The C entry point `symbol` of csrc/<name>.cu, typed once: n_ptr
    pointer arguments, then n_int ints, then the ctypes in `tail`; it
    returns the launch's cudaError_t as an int."""
    fn = _fns.get((name, symbol))
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
            + list(tail)
        fn.restype = ctypes.c_int
        _fns[(name, symbol)] = fn
    return fn

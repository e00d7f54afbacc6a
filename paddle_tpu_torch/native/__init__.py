"""Native (C++) host tier of the port — built on demand, bound via ctypes
(counterpart of ``paddle_tpu/native/__init__.py``; this package keeps
its own copy of the source).

  kv_store.cc — the sparse-row KV behind ``LargeScaleKV`` (reference
      operators/distributed/large_scale_kv.h): open-addressing id->slot
      hash + contiguous float arena; pull/push never enter the Python
      interpreter per row. The same ``std::mt19937_64`` seed draws the
      same rows as the JAX package's copy, so both packages' tables
      start bit-equal.

Build: one ``g++ -O3 -shared -fPIC -std=c++17`` at first use, cached
under ``native/build/`` and rebuilt when the source is newer. Plain C
ABI + ctypes (no pybind11). No torch: the parameter-server shards load
this and nothing of the card.
"""
from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import tempfile
import threading

import numpy as np

__all__ = ["load_library", "NativeKV", "available"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(_DIR, "build")
_SO = "libpaddle_tpu_torch_native.so"
_lock = threading.Lock()
_lib = None
_load_failed = False


def load_library():
    """Compile (if stale) and dlopen the native library; None when no
    toolchain is available (callers fall back to numpy)."""
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        src = os.path.join(_DIR, "kv_store.cc")
        so = os.path.join(_BUILD, _SO)
        try:
            if (not os.path.exists(so)
                    or os.path.getmtime(so) < os.path.getmtime(src)):
                os.makedirs(_BUILD, exist_ok=True)
                # per-process temp name: shard processes starting at once
                # must not interleave writes before the atomic replace
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
                os.close(fd)
                try:
                    subprocess.run(
                        ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                         src, "-o", tmp],
                        check=True, capture_output=True, text=True)
                    os.replace(tmp, so)
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
            lib = ctypes.CDLL(so)
        except (OSError, subprocess.CalledProcessError) as e:
            logging.getLogger(__name__).warning(
                "native tier unavailable (%s); using the numpy path", e)
            _load_failed = True
            return None
        lib.kv_create.restype = ctypes.c_void_p
        lib.kv_create.argtypes = [ctypes.c_int64, ctypes.c_float,
                                  ctypes.c_uint64]
        lib.kv_destroy.argtypes = [ctypes.c_void_p]
        lib.kv_size.restype = ctypes.c_int64
        lib.kv_size.argtypes = [ctypes.c_void_p]
        P_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        P_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.kv_pull.argtypes = [ctypes.c_void_p, P_i64, ctypes.c_int64,
                                P_f32]
        lib.kv_push.argtypes = [ctypes.c_void_p, P_i64, ctypes.c_int64,
                                P_f32, ctypes.c_float]
        lib.kv_export.argtypes = [ctypes.c_void_p, P_i64, P_f32]
        lib.kv_import.argtypes = [ctypes.c_void_p, P_i64, ctypes.c_int64,
                                  P_f32]
        _lib = lib
        return _lib


def available() -> bool:
    return load_library() is not None


class NativeKV:
    """ctypes wrapper over kv_store.cc (the same contract as the numpy
    path of ``LargeScaleKV``)."""

    def __init__(self, dim: int, init_std: float = 0.01, seed: int = 0):
        self._lib = load_library()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self.dim = int(dim)
        self._h = self._lib.kv_create(self.dim, float(init_std), int(seed))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h and getattr(self, "_lib", None) is not None:
            self._lib.kv_destroy(h)
            self._h = None

    _SENTINEL = np.int64(np.iinfo(np.int64).min)

    @classmethod
    def _check_keys(cls, ks):
        if len(ks) and ks.min() == cls._SENTINEL:
            raise ValueError(
                "key INT64_MIN is reserved (open-addressing empty "
                "sentinel)")
        return ks

    def pull(self, keys) -> np.ndarray:
        ks = self._check_keys(
            np.ascontiguousarray(np.asarray(keys, np.int64).ravel()))
        out = np.empty((len(ks), self.dim), np.float32)
        self._lib.kv_pull(self._h, ks, len(ks), out)
        return out

    def push(self, keys, grads, lr: float = 1.0):
        ks = self._check_keys(
            np.ascontiguousarray(np.asarray(keys, np.int64).ravel()))
        g = np.ascontiguousarray(
            np.asarray(grads, np.float32).reshape(len(ks), self.dim))
        self._lib.kv_push(self._h, ks, len(ks), g, float(lr))

    def size(self) -> int:
        return int(self._lib.kv_size(self._h))

    def export(self):
        n = self.size()
        keys = np.empty((n,), np.int64)
        rows = np.empty((n, self.dim), np.float32)
        if n:
            self._lib.kv_export(self._h, keys, rows)
        return keys, rows

    def import_(self, keys, rows):
        ks = np.ascontiguousarray(np.asarray(keys, np.int64).ravel())
        r = np.ascontiguousarray(
            np.asarray(rows, np.float32).reshape(len(ks), self.dim))
        self._lib.kv_import(self._h, ks, len(ks), r)

"""Low-level helpers of the static graph: dtypes, places, global flags
(counterpart of ``paddle_tpu/fluid/core.py``).

A ``Place`` names the device the Executor runs a Program on:
``CPUPlace()`` (the plain versions of the kernels) or ``CUDAPlace(i)``
(card i, where the ops launch the port's kernels). ``default_place()``
is the first card and raises on a host without one, so an
``Executor()`` runs on the CPU only when asked to.

Dtypes are canonical strings as in the reference ("float32", "int64",
...); ``torch_dtype`` maps them to torch's.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

__all__ = ["Place", "CPUPlace", "CUDAPlace", "default_place",
           "convert_dtype", "torch_dtype", "batched_to_numpy", "get_flags",
           "set_flags"]

# ---------------------------------------------------------------------------
# dtypes
# ---------------------------------------------------------------------------

_DTYPE_ALIASES = {
    "float32": "float32", "fp32": "float32", "float": "float32",
    "float64": "float64", "fp64": "float64", "double": "float64",
    "float16": "float16", "fp16": "float16", "half": "float16",
    "bfloat16": "bfloat16", "bf16": "bfloat16",
    "int8": "int8", "uint8": "uint8", "int16": "int16",
    "int32": "int32", "int64": "int64", "bool": "bool",
    "complex64": "complex64", "complex128": "complex128",
}

_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
    "complex64": torch.complex64, "complex128": torch.complex128,
}
_TORCH_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def convert_dtype(dtype: Any) -> str:
    """Normalise any dtype spec (str / numpy / torch) to a canonical
    string."""
    if dtype is None:
        return "float32"
    if isinstance(dtype, str):
        s = dtype.lower()
        if s in _DTYPE_ALIASES:
            return _DTYPE_ALIASES[s]
        raise ValueError(f"unsupported dtype string {dtype!r}")
    if isinstance(dtype, torch.dtype):
        if dtype in _TORCH_NAMES:
            return _TORCH_NAMES[dtype]
        raise ValueError(f"unsupported dtype {dtype}")
    name = getattr(dtype, "name", None)
    if name and name in _DTYPE_ALIASES:
        return _DTYPE_ALIASES[name]
    return np.dtype(dtype).name


def torch_dtype(dtype: Any) -> torch.dtype:
    return _TORCH_DTYPES[convert_dtype(dtype)]


def batched_to_numpy(tensors):
    """Host copies of `tensors` (numpy arrays and scalars pass through);
    bfloat16, which numpy lacks, comes back as float32. The first copy
    synchronises the device once; the rest find their values ready."""
    out = []
    for t in tensors:
        if isinstance(t, torch.Tensor):
            t = t.detach()
            if t.dtype == torch.bfloat16:
                t = t.float()
            out.append(t.cpu().numpy())
        else:
            out.append(np.asarray(t))
    return out


# ---------------------------------------------------------------------------
# Places
# ---------------------------------------------------------------------------

class Place:
    """Base device tag (the reference's platform/place.h PlaceBase)."""

    kind: str = "cpu"
    device_id: int = 0

    def __eq__(self, other):
        return (type(self) is type(other)
                and self.device_id == getattr(other, "device_id", 0))

    def __hash__(self):
        return hash((type(self).__name__, self.device_id))

    def __repr__(self):
        return f"{type(self).__name__}({self.device_id})"

    def torch_device(self) -> torch.device:
        raise NotImplementedError


class CPUPlace(Place):
    kind = "cpu"

    def __init__(self, device_id: int = 0):
        self.device_id = device_id

    def torch_device(self) -> torch.device:
        return torch.device("cpu")


class CUDAPlace(Place):
    """Card `device_id`; raises when it is used on a host without it."""
    kind = "cuda"

    def __init__(self, device_id: int = 0):
        self.device_id = device_id

    def torch_device(self) -> torch.device:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{self!r}: no CUDA card on this host; pass CPUPlace() to "
                f"run the program on the CPU")
        if self.device_id >= torch.cuda.device_count():
            raise RuntimeError(f"{self!r}: this host has "
                               f"{torch.cuda.device_count()} card(s)")
        return torch.device("cuda", self.device_id)


def default_place() -> Place:
    """The first card. Raises without one: the CPU is only ever taken
    when asked for with CPUPlace()."""
    place = CUDAPlace(0)
    place.torch_device()
    return place


# ---------------------------------------------------------------------------
# Global flags (the reference's platform/flags.cc)
# ---------------------------------------------------------------------------

_FLAGS: dict[str, Any] = {
    "FLAGS_check_nan_inf": False,        # post-step NaN/Inf sweep
    "FLAGS_benchmark": False,            # synchronise the card per run
    "FLAGS_jit_cache_size": 512,         # executor plan-cache entries
}


def _load_env_flags():
    for k, cur in _FLAGS.items():
        v = os.environ.get(k)
        if v is not None:
            _FLAGS[k] = (v.lower() in ("1", "true", "yes")
                         if isinstance(cur, bool) else int(v))


_load_env_flags()


def get_flags(keys):
    if isinstance(keys, str):
        keys = [keys]
    return {k: _FLAGS.get(k) for k in keys}


def set_flags(flags: dict):
    for k, v in flags.items():
        if k not in _FLAGS:
            raise ValueError(f"unknown flag {k!r}; the port has "
                             f"{sorted(_FLAGS)}")
        _FLAGS[k] = v

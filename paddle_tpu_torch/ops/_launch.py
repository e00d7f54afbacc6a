"""What every kernel wrapper does before and after its launch: decide
between the kernel and the plain version by the tensor's device, check
devices, types and layout, keep the kernels' scratch per stream, and
turn a launch's error code into an exception."""
from __future__ import annotations

import functools
import threading

import torch

__all__ = ["_route", "_check", "_dtype_code", "_raise_if", "_drop_args",
           "_sms", "enqueue_lock", "keep_threshold", "workspace"]

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernels' scratch, by (device index, stream, name): split partials
# ("part"), tickets ("tickets"), the stream route's hid and xn
_WORK: dict = {}
# one lock a (device index, stream), guarding that stream's workspace
# (enqueue_lock)
_ENQUEUE: dict = {}
_ENQUEUE_GUARD = threading.Lock()


def workspace(device, stream, name, numel, dtype=torch.float32):
    """The scratch tensor `name` of `stream` on `device`, at least `numel`
    elements, kept between calls and replaced by a larger one when short.
    An int32 one is made of zeros: the kernels take tickets from it and
    the last block to take each sets it back to zero, so it is zero
    between launches. Launches on one stream never overlap, so they may
    share a tensor; two streams never do. Callers hold the stream's
    `enqueue_lock` from this call until their launches are enqueued."""
    key = (device.index, stream, name)
    t = _WORK.get(key)
    if t is None or t.numel() < numel:
        make = torch.zeros if dtype == torch.int32 else torch.empty
        t = _WORK[key] = make(numel, dtype=dtype, device=device)
    return t


def enqueue_lock(device, stream) -> threading.Lock:
    """The lock of `stream`'s workspace: a call holds it from taking a
    buffer to the last launch that uses it. Two threads may launch on
    one stream (two engines in one process), and the ctypes call that
    enqueues launches releases the GIL. Without the lock their launches
    could interleave where one launch hands a buffer to the next (the
    stream route's hid: written by the first product, read by the
    second), so one thread's second product would read the other's
    hid; and a buffer replaced by a larger one could be freed before a
    launch that took its address is enqueued. Held only while launches
    are enqueued: the kernels still run one after another on the
    stream."""
    key = (device.index, stream)
    with _ENQUEUE_GUARD:
        lock = _ENQUEUE.get(key)
        if lock is None:
            lock = _ENQUEUE[key] = threading.Lock()
    return lock


@functools.cache
def _sms(index: int) -> int:
    """The card's multiprocessor count (one entry per device index)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _route(t, what):
    """False for a CPU tensor (plain version), True for a CUDA tensor
    (kernel); any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {t.device}")
    return True


def _check(name_tensors, dev, dtype):
    for name, t in name_tensors:
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype} for the kernel, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _dtype_code(t, what):
    if t.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{what} takes float32 or bfloat16 inputs, got "
                        f"{t.dtype}")
    return _KERNEL_DTYPES[t.dtype]


def _raise_if(err, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def keep_threshold(p: float) -> int:
    """The uint32 threshold of dropout probability p: an element is kept
    where its hash is >= min(int(p * 2**32), 2**32 - 1)."""
    return min(int(p * 4294967296.0), 4294967295)


def _drop_args(seed, p):
    """(seed, on, threshold, 1 - p) as the kernels take a dropout: the
    int32 seed, whether p > 0, the uint32 keep threshold
    min(int(p * 2**32), 2**32 - 1), and the divisor of kept elements."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 32:
        raise ValueError(f"dropout seed {seed} does not fit 32 bits")
    if seed >= 2 ** 31:
        seed -= 2 ** 32
    if not 0.0 <= p < 1.0:
        raise ValueError(f"dropout p must be in [0, 1), got {p}")
    return seed, int(p > 0.0), keep_threshold(p), 1.0 - p

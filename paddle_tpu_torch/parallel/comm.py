"""What the hybrid train step sends between its ranks, timed by kind.

The reference's hybrid step is one SPMD program: XLA inserts its tp
all-reduces, its pp ``ppermute`` hops and its dp gradient sums. The
port runs one process per rank, so each of those is a call here or in
``distributed/collective.py`` / ``distributed/parallel.py``, over the
process group of its mesh axis, and its host wall time adds to
``seconds[kind]`` (the train step's kinds: "tp", "pp_send", "pp_recv",
"sp" (the ring's hops), "ep" (the expert sums and the routing counts),
"dp", "grad", "loss", "zero"). ``Comm`` holds what the shared layer
lacks:

  * ``timed(kind, t)``: a span around any call (the dp buckets, the
    ZeRO-1 gathers).
  * ``all_reduce``: in place, the identity over a group of one rank;
    16-bit floats are summed in float32 and rounded back once.
  * ``send`` / ``recv``: point-to-point along the pp axis. ``send`` does
    not block (``isend``; ``wait_sends`` closes the step's sends);
    ``recv`` blocks until the tensor is here, so its time includes the
    wait for the neighbour stage (the pipeline's bubble).
  * ``shift``: one ring hop (sp): t sent to one neighbour while the
    other's tensor is received; returns when both are done.

Where the backend is gloo and the tensor is on a card (ranks sharing
one card, where NCCL refuses), p2p goes through a host copy: gloo's
send / recv take CPU tensors only (a CUDA tensor's send fails in the
transport's writev and ends the process). All-reduce and all-gather
hand gloo the CUDA tensor, which it stages itself. A span over a CUDA
tensor first drains the card, so its time is the collective's, not the
kernels' queued before it.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch
import torch.distributed as dist

__all__ = ["Comm"]


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _host_staged(t, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _wire(t):
    """A view gloo's p2p can carry: 16-bit floats travel as int16."""
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.view(torch.int16)
    return t


class Comm:
    """The timed calls of one rank; ``seconds`` holds the host seconds
    spent in each kind since ``reset``."""

    def __init__(self):
        self.seconds = defaultdict(float)
        self._pending = []

    def reset(self):
        self.seconds.clear()

    def _start(self, t):
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        return time.perf_counter()

    def _stop(self, kind, t0):
        self.seconds[kind] += time.perf_counter() - t0

    @contextlib.contextmanager
    def timed(self, kind: str, t):
        """The block's host seconds add to `kind`; t's card is drained
        first."""
        t0 = self._start(t)
        try:
            yield
        finally:
            self._stop(kind, t0)

    def all_reduce(self, t, group, kind: str, op=dist.ReduceOp.SUM):
        """t summed (or `op`) over `group`, in place; returns t."""
        if group_size(group) == 1:
            return t
        with self.timed(kind, t):
            if t.dtype in (torch.bfloat16, torch.float16):
                wide = t.float()
                dist.all_reduce(wide, op, group=group)
                t.copy_(wide)
            else:
                dist.all_reduce(t, op, group=group)
        return t

    def _isend(self, t, dst: int, group, tag: int):
        """isend of a copy of t (on the host where gloo stages it);
        returns the work and the copy, which must live until it ends."""
        buf = t.detach()
        buf = buf.to("cpu") if _host_staged(buf, group) else \
            buf.contiguous().clone()
        return dist.isend(_wire(buf), dst, group=group, tag=tag), buf

    def _recv(self, shape, dtype, device, src: int, group, tag: int):
        staged = device.type == "cuda" and dist.get_backend(group) == "gloo"
        buf = torch.empty(shape, dtype=dtype,
                          device="cpu" if staged else device)
        dist.recv(_wire(buf), src, group=group, tag=tag)
        return buf.to(device) if staged else buf

    def send(self, t, dst: int, group, tag: int, kind: str):
        """Start sending t to world rank `dst`; returns at once."""
        t0 = self._start(t)
        self._pending.append(self._isend(t, dst, group, tag))
        self._stop(kind, t0)

    def recv(self, shape, dtype, device, src: int, group, tag: int,
             kind: str):
        """The tensor world rank `src` sends with `tag`, on `device`."""
        t0 = time.perf_counter()
        out = self._recv(shape, dtype, device, src, group, tag)
        self._stop(kind, t0)
        return out

    def shift(self, t, dst: int, src: int, group, kind: str):
        """t sent to world rank `dst` while the tensor of t's shape from
        world rank `src` is received and returned (on t's device)."""
        t0 = self._start(t)
        work, _ = self._isend(t, dst, group, 0)
        out = self._recv(t.shape, t.dtype, t.device, src, group, 0)
        work.wait()
        self._stop(kind, t0)
        return out

    def wait_sends(self, kind: str):
        t0 = time.perf_counter()
        for work, _ in self._pending:
            work.wait()
        self._pending.clear()
        self._stop(kind, t0)

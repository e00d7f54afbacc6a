"""Replayable stochastic decode: Philox-keyed temperature/top-k/top-p
(counterpart of ``paddle_tpu/serving/sampling.py``).

Randomness is the counter-based Philox4x32-10 generator keyed by the
request's 64-bit seed and counted by the decode step:

    uniform = philox(key=(seed_lo, seed_hi), counter=(step, 0, 0, 0))

PyTorch has no full uint32 arithmetic on CUDA, so the device stream
holds each uint32 lane in an int64 tensor and keeps the 16-bit split of
the 32x32 product (a full product can reach 2^64 and overflow int64).
Every intermediate is then exact, and the uniform is bit-identical to
``philox_uniform_host`` — the numpy mirror — and to the JAX package.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

__all__ = ["SamplingParams", "sample_tokens", "seed_to_key",
           "derive_seed", "philox_uniform_host", "uniform"]

# Philox4x32 round/bump constants (Salmon et al., SC'11)
_M0 = 0xD2511F53
_M1 = 0xCD9E8D57
_W0 = 0x9E3779B9
_W1 = 0xBB67AE85
_U32 = 0xFFFFFFFF


class SamplingParams:
    """Validated request sampling knobs. temperature == 0 means greedy
    (top_k/top_p ignored); seed None means "derive from the request"."""

    __slots__ = ("temperature", "top_k", "top_p", "seed")

    def __init__(self, temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, seed: int | None = None):
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = None if seed is None else int(seed)
        if self.temperature < 0:
            raise ValueError("temperature must be >= 0")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0 (0 = disabled)")
        if not 0 < self.top_p <= 1:
            raise ValueError("top_p must be in (0, 1]")


def derive_seed(request_id) -> int:
    """Stable 64-bit seed from a request identity."""
    h = hashlib.blake2b(str(request_id).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big")


def seed_to_key(seed: int) -> np.ndarray:
    """64-bit seed -> uint32[2] Philox key (lo, hi)."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([s & _U32, s >> 32], np.uint32)


def _mulhilo(a, b):
    """Full 32x32->64 product of uint32 lanes held in int64: (hi, lo).
    The 16-bit split keeps every intermediate below 2^34."""
    m16 = 0xFFFF
    al, ah = a & m16, a >> 16
    bl, bh = b & m16, b >> 16
    p0 = al * bl
    t = ah * bl + (p0 >> 16)
    t2 = al * bh + (t & m16)
    hi = ah * bh + (t >> 16) + (t2 >> 16)
    lo = ((t2 & m16) << 16) | (p0 & m16)
    return hi, lo


def _philox4(k0, k1, c0, c1, c2, c3):
    """Ten Philox4x32 rounds over int64 tensors holding uint32 lanes."""
    m0 = torch.full_like(c0, _M0)
    m1 = torch.full_like(c0, _M1)
    for _ in range(10):
        hi0, lo0 = _mulhilo(m0, c0)
        hi1, lo1 = _mulhilo(m1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _U32
        k1 = (k1 + _W1) & _U32
    return c0


def uniform(seeds, steps):
    """One float32 uniform in [0, 1) per lane from key=(seed lo, hi),
    counter=(step, 0, 0, 0). seeds [..., 2] int64 holding uint32,
    steps [...] integer >= 0."""
    seeds = seeds.long()
    step = steps.long() & _U32
    zero = torch.zeros_like(step)
    x = _philox4(seeds[..., 0], seeds[..., 1], step, zero, zero, zero)
    # top 24 bits -> [0, 1): exact in float32
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def philox_uniform_host(seed: int, step: int) -> float:
    """The stream for one (seed, step), computed on the CPU."""
    key = torch.as_tensor(seed_to_key(seed).astype(np.int64)).reshape(1, 2)
    return float(uniform(key, torch.tensor([int(step)]))[0])


def sample_tokens(logits, temps, topks, topps, seeds, steps):
    """One token per slot.

    logits [S, V] f32; temps/topps [S] f32; topks/steps [S] int;
    seeds [S, 2] int64 holding uint32 (lo, hi). Returns [S] int32.

    temperature 0 -> plain argmax (first maximum, as jnp.argmax).
    temperature > 0: scale, keep the top-k logits and the top-p nucleus
    (the crossing token included), then one inverse-CDF draw with the
    slot's (seed, step) uniform."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    V = logits.shape[-1]
    scaled = logits / torch.where(temps > 0, temps,
                                  torch.ones_like(temps))[:, None]
    order = torch.sort(-scaled, dim=-1, stable=True).indices
    sl = torch.gather(scaled, -1, order)
    probs = torch.softmax(sl, dim=-1)
    k_eff = torch.where(topks > 0, torch.clamp(topks, 1, V),
                        torch.full_like(topks, V))
    rank = torch.arange(V, device=logits.device)[None, :]
    csum = torch.cumsum(probs, dim=-1)
    # nucleus: keep while the mass BEFORE a token is < top_p, which
    # always includes the crossing token (and rank 0)
    keep = (rank < k_eff[:, None]) & ((csum - probs) < topps[:, None])
    w = torch.where(keep, probs, torch.zeros_like(probs))
    cdf = torch.cumsum(w, dim=-1)
    u = uniform(seeds, steps)
    target = u * cdf[:, -1]
    pick = (cdf <= target[:, None]).to(torch.int64).sum(-1)
    pick = torch.clamp(pick, 0, V - 1)   # u*total rounding up to total
    sampled = torch.gather(order, -1, pick[:, None])[:, 0].to(torch.int32)
    return torch.where(temps > 0, sampled, greedy)

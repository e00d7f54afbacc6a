"""GPT-style causal decoder in PyTorch (counterpart of
``paddle_tpu/models/gpt.py``).

Parameters are a plain dictionary of tensors in the JAX package's
layout — a linear weight ``w`` stays ``(Din, Dout)`` — so both packages
compute the same function from the same numbers. ``params["blocks"]`` is
either a list of per-layer dictionaries (the serving model's form) or
the JAX pytree's dictionary of stacked ``[L, ...]`` leaves (the train
step's form, unbound per call with ``torch.unbind``, whose backward is
one ``stack``); the ``lax.scan`` over layers becomes a Python loop, and
``cfg.remat`` recomputes each layer in the backward
(``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``).

The dense pre-LN decoder tail (``decoder_tail``) runs the two fused
sub-block kernels of ``ops/fused_block.py``; causal attention is plain
PyTorch with impl "xla" (the JAX package left it to XLA) and the flash
kernels of ``ops/flash_attention.py`` with impl "flash".
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..ops.flash_attention import flash_attention
from ..ops.fused_block import fused_ffn_ln, fused_out_ln, gelu_tanh

__all__ = ["GPTConfig", "init_gpt_params", "param_shapes",
           "params_from_jax", "gpt_forward", "gpt_forward_aux", "gpt_loss",
           "gpt_block_fn", "block_body", "decoder_tail", "resolve_device",
           "disable_tf32"]


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 1024
    intermediate_size: int | None = None  # default 4*hidden
    layer_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    # residual dropout of the train step; the reference draws it from
    # jax.random, which torch cannot replay, so only 0.0 is ported
    dropout: float = 0.0
    # "bfloat16" casts block compute (training) and sets the serving KV
    # cache dtype
    amp_dtype: str | None = None
    attn_impl: str = "xla"  # "xla" | "flash"; "ring" comes with slice 5
    # Mixture-of-Experts blocks come with the multi-device slice; the
    # moe_* fields keep the JAX package's defaults so a config written
    # into a checkpoint's manifest by either package rebuilds in both
    num_experts: int = 0
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    # recompute each block in the backward (torch.utils.checkpoint)
    remat: bool = True
    # True runs the decoder tail through the fused sub-block kernels
    # (plain versions on CPU); False pins the composed chain, as in the
    # JAX package
    fused_blocks: bool = True

    def __post_init__(self):
        if self.intermediate_size is None:
            self.intermediate_size = 4 * self.hidden_size
        if self.hidden_size % self.num_heads:
            raise ValueError("hidden_size must be a multiple of num_heads")
        if self.num_experts > 0:
            raise NotImplementedError(
                "num_experts > 0 (MoE blocks, the ep mesh axis) comes with "
                "slice 5 of the port (multi-device)")

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("vocab_size", 512)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("num_layers", 4)
        kw.setdefault("num_heads", 4)
        kw.setdefault("max_position_embeddings", 128)
        return cls(**kw)

    @classmethod
    def gpt3_1p3b(cls, **kw):
        """GPT-3 XL: 24 layers, d_model 2048, 16 heads of 128."""
        kw.setdefault("hidden_size", 2048)
        kw.setdefault("num_layers", 24)
        kw.setdefault("num_heads", 16)
        kw.setdefault("max_position_embeddings", 2048)
        return cls(**kw)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Without a card, the default raises instead of quietly
    running on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on a CUDA card and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           f"available")
    return dev


def disable_tf32():
    # the JAX reference runs f32 matmuls at "highest" precision
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def init_gpt_params(cfg: GPTConfig, seed: int = 0) -> dict:
    """Numpy pytree, bit-identical to the JAX package's init_gpt_params
    for the same seed: embeddings + stacked dense blocks [L, ...] + final
    LN. The LM head is tied to wte. Dense blocks only: expert (MoE)
    blocks are not ported."""
    rng = np.random.RandomState(seed)
    D, F, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    s = cfg.initializer_range

    def norm(*shape):
        return rng.normal(0.0, s, shape).astype(np.float32)

    blocks = {
        "ln1_s": np.ones((L, D), np.float32),
        "ln1_b": np.zeros((L, D), np.float32),
        "wq": norm(L, D, D), "bq": np.zeros((L, D), np.float32),
        "wk": norm(L, D, D), "bk": np.zeros((L, D), np.float32),
        "wv": norm(L, D, D), "bv": np.zeros((L, D), np.float32),
        # output/down projections scaled 1/sqrt(2L) (GPT-2 residual scaling)
        "wo": norm(L, D, D) / math.sqrt(2 * L),
        "bo": np.zeros((L, D), np.float32),
        "ln2_s": np.ones((L, D), np.float32),
        "ln2_b": np.zeros((L, D), np.float32),
        "w_up": norm(L, D, F), "b_up": np.zeros((L, F), np.float32),
        "w_down": norm(L, F, D) / math.sqrt(2 * L),
        "b_down": np.zeros((L, D), np.float32),
    }
    return {
        "wte": norm(cfg.vocab_size, D),
        "wpe": norm(cfg.max_position_embeddings, D),
        "blocks": blocks,
        "lnf_s": np.ones((D,), np.float32),
        "lnf_b": np.zeros((D,), np.float32),
    }


def param_shapes(cfg: GPTConfig) -> dict:
    """The shapes of ``init_gpt_params(cfg)``'s tree, same keys, without
    drawing it (every leaf is float32): the template a checkpoint restore
    checks its arrays against."""
    D, F, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    widths = {"b_up": (F,), "w_up": (D, F), "w_down": (F, D)}
    names = ("ln1_s", "ln1_b", "wq", "bq", "wk", "bk", "wv", "bv", "wo",
             "bo", "ln2_s", "ln2_b", "w_up", "b_up", "w_down", "b_down")
    blocks = {k: (L,) + widths.get(k, (D, D) if k[0] == "w" else (D,))
              for k in names}
    return {"wte": (cfg.vocab_size, D),
            "wpe": (cfg.max_position_embeddings, D), "blocks": blocks,
            "lnf_s": (D,), "lnf_b": (D,)}


def params_from_jax(tree: dict, device="cpu") -> dict:
    """The port's parameters from a JAX-layout pytree (``init_gpt_params``
    output or ``GPTDecodeModel.params``; leaves tensors, numpy or
    anything ``np.asarray`` takes). Stacked ``blocks/*`` leaves ``[L, ...]``
    become a list of per-layer dicts; layouts are unchanged."""
    dev = torch.device(device)

    def t(x):
        if isinstance(x, torch.Tensor):
            return x.to(dev)
        return torch.as_tensor(np.asarray(x)).to(dev)

    stacked = {k: t(v) for k, v in tree["blocks"].items()}
    L = next(iter(stacked.values())).shape[0]
    out = {k: t(tree[k]) for k in ("wte", "wpe", "lnf_s", "lnf_b")}
    out["blocks"] = [{k: v[l] for k, v in stacked.items()}
                     for l in range(L)]
    return out


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _ln(x, scale, bias, eps):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = torch.square(x32 - mu).mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def _causal_attention(q, k, v, n_heads, impl="xla"):
    """q,k,v: [B, T, D] -> [B, T, D] (contiguous); softmax in fp32.
    impl "flash" runs the flash kernels (T a multiple of 64)."""
    if impl not in ("xla", "flash"):
        raise NotImplementedError(
            f"attn_impl={impl!r}: ring attention comes with slice 5 of the "
            f"port (multi-device)")
    B, T, D = q.shape
    hd = D // n_heads
    q = q.reshape(B, T, n_heads, hd)
    k = k.reshape(B, T, n_heads, hd)
    v = v.reshape(B, T, n_heads, hd)
    if impl == "flash":
        qh, kh, vh = (a.transpose(1, 2) for a in (q, k, v))
        o = flash_attention(qh, kh, vh, causal=True)
        return o.transpose(1, 2).reshape(B, T, D)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                 device=q.device))
    scores = torch.where(mask, scores.float(),
                         torch.full_like(scores, -1e30, dtype=torch.float32))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return o.reshape(B, T, D).contiguous()


def decoder_tail(p, a2, x2, cfg: GPTConfig):
    """Post-attention tail of a dense pre-LN decoder block, 2-d form:

        z = x2 + a2 @ wo + bo
        h = LN2(z)
        out = z + gelu_tanh(h @ w_up + b_up) @ w_down + b_down

    a2/x2: (M, D) contiguous. With cfg.fused_blocks the two sub-blocks
    are the fused kernels (their plain versions for CPU tensors)."""
    cdt = x2.dtype
    wo, bo = p["wo"].to(cdt), p["bo"].to(cdt)
    w_up, b_up = p["w_up"].to(cdt), p["b_up"].to(cdt)
    w_down, b_down = p["w_down"].to(cdt), p["b_down"].to(cdt)
    eps = cfg.layer_norm_eps
    if cfg.fused_blocks:
        z, h = fused_out_ln(a2, wo, bo, x2, p["ln2_s"], p["ln2_b"],
                            eps=eps)
        return fused_ffn_ln(h.to(cdt), w_up, b_up, w_down, b_down, z,
                            eps=eps)
    z = x2 + (a2 @ wo + bo).to(x2.dtype)
    h = _ln(z, p["ln2_s"], p["ln2_b"], eps)
    u = gelu_tanh(h.to(cdt) @ w_up + b_up)
    dn = u @ w_down + b_down
    return z + dn.to(z.dtype)


def gpt_block_fn(p: dict, x, cfg: GPTConfig):
    """One pre-LN decoder block on [B, T, D] (deterministic dense path:
    no dropout, no experts). Returns the new x."""
    cdt = getattr(torch, cfg.amp_dtype) if cfg.amp_dtype else x.dtype

    def c(a):
        return a.to(cdt)

    h = _ln(x, p["ln1_s"], p["ln1_b"], cfg.layer_norm_eps)
    q = c(h) @ c(p["wq"]) + c(p["bq"])
    k = c(h) @ c(p["wk"]) + c(p["bk"])
    v = c(h) @ c(p["wv"]) + c(p["bv"])
    a = _causal_attention(q, k, v, cfg.num_heads, cfg.attn_impl)
    B, T, D = x.shape
    return decoder_tail(p, c(a).reshape(B * T, D),
                        x.reshape(B * T, D), cfg).reshape(B, T, D)


def _embed(params, ids, cfg: GPTConfig):
    T = ids.shape[-1]
    if T > params["wpe"].shape[0]:
        raise ValueError(
            f"sequence length {T} exceeds max_position_embeddings="
            f"{params['wpe'].shape[0]}")
    ids = torch.as_tensor(ids, device=params["wte"].device).long()
    x = params["wte"][ids] + params["wpe"][:T]
    if cfg.amp_dtype:
        x = x.to(getattr(torch, cfg.amp_dtype))
    return x


def _head(params, x, cfg: GPTConfig):
    x = _ln(x, params["lnf_s"], params["lnf_b"], cfg.layer_norm_eps)
    # logits in fp32 for a stable softmax-xent
    return x.float() @ params["wte"].float().T


def _layers(blocks) -> list[dict]:
    """Per-layer parameter dictionaries from a list of them or from a
    dictionary of stacked [L, ...] leaves (one unbind per leaf: its
    backward is a single stack, where indexing layer by layer would
    build a full [L, ...] zero gradient per layer)."""
    if not isinstance(blocks, dict):
        return blocks
    per = {k: torch.unbind(v) for k, v in blocks.items()}
    n = len(next(iter(per.values())))
    return [{k: v[l] for k, v in per.items()} for l in range(n)]


def block_body(cfg: GPTConfig):
    """(h, blk) -> h for one layer, recomputed in the backward when
    cfg.remat and autograd is recording (the reference's jax.checkpoint
    per layer)."""
    def body(h, blk):
        if cfg.remat and torch.is_grad_enabled():
            return checkpoint(gpt_block_fn, blk, h, cfg, use_reentrant=False)
        return gpt_block_fn(blk, h, cfg)
    return body


def gpt_forward_aux(params: dict, ids, cfg: GPTConfig):
    """(logits [B, T, V] float32, aux): aux is the MoE load-balance loss
    of the reference, 0.0 for the dense blocks the port has."""
    x = _embed(params, ids, cfg)
    body = block_body(cfg)
    for blk in _layers(params["blocks"]):
        x = body(x, blk)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _head(params, x, cfg), aux


def gpt_forward(params: dict, ids, cfg: GPTConfig):
    """ids [B, T] int -> logits [B, T, V] (float32)."""
    return gpt_forward_aux(params, ids, cfg)[0]


def gpt_loss(params: dict, ids, cfg: GPTConfig, logits=None):
    """Mean next-token cross entropy, as the reference computes it:
    logsumexp(logits) - gold logit, predicting ids[:, 1:] from
    ids[:, :-1]."""
    if logits is None:
        logits = gpt_forward_aux(params, ids, cfg)[0]
    ids = torch.as_tensor(ids, device=logits.device).long()
    logits = logits[:, :-1]
    labels = ids[:, 1:]
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.mean(logz - gold)

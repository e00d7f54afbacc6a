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
PyTorch with impl "xla" (the JAX package left it to XLA), the flash
kernels of ``ops/flash_attention.py`` with impl "flash", and ring
attention over the sp axis of an enclosing ``ring_context`` with impl
"ring" (``parallel/sequence_parallel.py``). With ``num_experts > 0``
every block's FFN is a routed expert bank (``parallel/moe.py``): the
composed chain, no fused tail, and the loss adds ``moe_aux_weight``
times the load-balance aux summed over the layers.

Residual dropout (``cfg.dropout``, the reference's GPT-2 placement: the
embedding output, the attention out-projection and the FFN
down-projection) is on when the forward is given a step seed ``key``.
The reference draws its masks from ``jax.random``, which torch cannot
replay; the port draws one int32 a dropout from the counter-hash seed
stream of ``nn.functional`` (``seed_scope(key)``: the embedding's first,
then two a layer), all before the first layer, so a layer recomputed in
the backward replays its masks. The fused sub-blocks apply the two
block dropouts in their epilogues; the composed tail drops with the same
keep masks (``ops.fused_residual.apply_keep``).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..ops.flash_attention import flash_attention
from ..nn import functional as F
from ..ops.fused_block import fused_ffn_ln, fused_out_ln, gelu_tanh
from ..ops.fused_residual import apply_keep

__all__ = ["GPTConfig", "init_gpt_params", "param_shapes",
           "params_from_jax", "gpt_param_specs", "shard_params",
           "gpt_forward", "gpt_forward_aux", "gpt_loss", "gpt_block_fn",
           "block_body", "decoder_tail", "moe_tail", "resolve_device",
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
    # residual dropout of the train step (masks from the port's seed
    # stream: the reference's jax.random cannot be replayed)
    dropout: float = 0.0
    # "bfloat16" casts block compute (training) and sets the serving KV
    # cache dtype
    amp_dtype: str | None = None
    attn_impl: str = "xla"  # "xla" | "flash" | "ring" (sp mesh)
    # Mixture-of-Experts (num_experts > 0 replaces every block's dense
    # FFN with a routed expert bank: parallel/moe.py, the "ep" axis)
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
    for the same seed (the same draws in the same order): embeddings +
    stacked blocks [L, ...] (dense, or with an expert bank when
    cfg.num_experts > 0) + final LN. The LM head is tied to wte."""
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
    }
    E = cfg.num_experts
    if E > 0:
        blocks.update({
            "wg": norm(L, D, E),
            "we_up": norm(L, E, D, F),
            "be_up": np.zeros((L, E, F), np.float32),
            "we_down": norm(L, E, F, D) / math.sqrt(2 * L),
            "be_down": np.zeros((L, E, D), np.float32),
        })
    else:
        blocks.update({
            "w_up": norm(L, D, F), "b_up": np.zeros((L, F), np.float32),
            "w_down": norm(L, F, D) / math.sqrt(2 * L),
            "b_down": np.zeros((L, D), np.float32),
        })
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
    E = cfg.num_experts
    widths = {"b_up": (F,), "w_up": (D, F), "w_down": (F, D),
              "wg": (D, E), "we_up": (E, D, F), "be_up": (E, F),
              "we_down": (E, F, D), "be_down": (E, D)}
    ffn = ("wg", "we_up", "be_up", "we_down", "be_down") if E > 0 else \
        ("w_up", "b_up", "w_down", "b_down")
    names = ("ln1_s", "ln1_b", "wq", "bq", "wk", "bk", "wv", "bv", "wo",
             "bo", "ln2_s", "ln2_b") + ffn
    blocks = {k: (L,) + widths.get(k, (D, D) if k[0] == "w" else (D,))
              for k in names}
    return {"wte": (cfg.vocab_size, D),
            "wpe": (cfg.max_position_embeddings, D), "blocks": blocks,
            "lnf_s": (D,), "lnf_b": (D,)}


def gpt_param_specs(pp_stacked: bool = False, moe: bool = False) -> dict:
    """Megatron-style tensor-parallel specs of the parameter tree (the
    reference's ``gpt_param_specs``), as tuples of axis names: the
    q/k/v and up projections and their biases split on columns over
    "tp" (a column split of wq is H/tp whole heads), the out and down
    projections on rows, wte over the vocabulary; block leaves carry a
    leading "pp" dimension when stacked per stage. With `moe` the
    expert bank splits its experts over "ep" and each expert over "tp"
    (up on columns, down on rows); the router wg is replicated."""
    def blk(*entries):
        return (*(("pp",) if pp_stacked else ()), None, *entries)

    blocks = {
        "ln1_s": blk(None), "ln1_b": blk(None),
        "wq": blk(None, "tp"), "bq": blk("tp"),
        "wk": blk(None, "tp"), "bk": blk("tp"),
        "wv": blk(None, "tp"), "bv": blk("tp"),
        "wo": blk("tp", None), "bo": blk(None),
        "ln2_s": blk(None), "ln2_b": blk(None),
    }
    if moe:
        blocks.update({
            "wg": blk(None, None),
            "we_up": blk("ep", None, "tp"), "be_up": blk("ep", "tp"),
            "we_down": blk("ep", "tp", None), "be_down": blk("ep", None),
        })
    else:
        blocks.update({
            "w_up": blk(None, "tp"), "b_up": blk("tp"),
            "w_down": blk("tp", None), "b_down": blk(None),
        })
    return {"wte": ("tp", None), "wpe": (), "blocks": blocks,
            "lnf_s": (), "lnf_b": ()}


def shard_params(tree: dict, coords: dict, sizes: dict,
                 names=None) -> dict:
    """This rank's pieces of a full reference-layout tree (numpy arrays
    or memmaps; block leaves [L, ...]) under ``gpt_param_specs``: block
    leaves cut to the rank's pp stage (L/pp layers, the leading pp
    dimension of the stacked specs) and every leaf to its tp and ep
    parts (an expert bank when the tree has one);
    `coords` / `sizes` map axis names to this rank's index and the
    axis's size. `names` (top-level keys) keeps only those leaves, so a
    stage reads only what it holds. Only the pieces are read from a
    memmap; each comes back as a fresh float32 numpy array."""
    specs = gpt_param_specs(pp_stacked=True,
                            moe="wg" in tree.get("blocks", {}))
    from ..parallel.sharding import shard_of
    pp = sizes.get("pp", 1)

    def piece(v, spec):
        return np.array(shard_of(v, spec, coords, sizes), dtype=np.float32,
                        order="C", copy=True)

    out = {}
    for k in ("wte", "wpe", "lnf_s", "lnf_b"):
        if names is None or k in names:
            out[k] = piece(tree[k], specs[k])
    if names is None or "blocks" in names:
        blocks = {}
        for k, v in tree["blocks"].items():
            L = v.shape[0]
            if L % pp:
                raise ValueError(f"num_layers={L} not divisible by pp={pp}")
            stacked = v.reshape(pp, L // pp, *v.shape[1:])
            blocks[k] = piece(stacked, specs["blocks"][k])[0] if pp > 1 \
                else piece(v, specs["blocks"][k][1:])
        out["blocks"] = blocks
    return out


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
    impl "flash" runs the flash kernels (T a multiple of 64); impl
    "ring" ring-attends over the axis of the enclosing ``ring_context``
    (T is this rank's shard of the sequence)."""
    B, T, D = q.shape
    hd = D // n_heads
    q = q.reshape(B, T, n_heads, hd)
    k = k.reshape(B, T, n_heads, hd)
    v = v.reshape(B, T, n_heads, hd)
    if impl == "ring":
        from ..parallel.sequence_parallel import current_ring, \
            ring_attention
        ctx = current_ring()
        if ctx is None:
            raise RuntimeError(
                "attn_impl='ring' needs an enclosing ring_context(mesh, "
                "axis)")
        mesh, axis = ctx
        o = ring_attention(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), mesh, axis, causal=True)
        return o.transpose(1, 2).reshape(B, T, D)
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


def _drop(y, p, seed):
    """Dropout at rate p with the keep mask of int32 `seed`, in f32 as
    the fused sub-blocks drop, back in y's type."""
    return y if p <= 0.0 else apply_keep(y.float(), seed, p).to(y.dtype)


def decoder_tail(p, a2, x2, cfg: GPTConfig, drop: float = 0.0,
                 seeds=(0, 0)):
    """Post-attention tail of a dense pre-LN decoder block, 2-d form:

        z = x2 + dropout(a2 @ wo + bo)
        h = LN2(z)
        out = z + dropout(gelu_tanh(h @ w_up + b_up) @ w_down + b_down)

    a2/x2: (M, D) contiguous; dropout at rate `drop` with the masks of
    the two int32 `seeds` (none at 0). With cfg.fused_blocks the two
    sub-blocks are the fused kernels (their plain versions for CPU
    tensors)."""
    cdt = x2.dtype
    wo, bo = p["wo"].to(cdt), p["bo"].to(cdt)
    w_up, b_up = p["w_up"].to(cdt), p["b_up"].to(cdt)
    w_down, b_down = p["w_down"].to(cdt), p["b_down"].to(cdt)
    eps = cfg.layer_norm_eps
    if cfg.fused_blocks:
        z, h = fused_out_ln(a2, wo, bo, x2, p["ln2_s"], p["ln2_b"],
                            p=drop, eps=eps, seed=seeds[0])
        return fused_ffn_ln(h.to(cdt), w_up, b_up, w_down, b_down, z,
                            p=drop, eps=eps, seed=seeds[1])
    z = x2 + _drop(a2 @ wo + bo, drop, seeds[0]).to(x2.dtype)
    h = _ln(z, p["ln2_s"], p["ln2_b"], eps)
    u = gelu_tanh(h.to(cdt) @ w_up + b_up)
    dn = _drop(u @ w_down + b_down, drop, seeds[1])
    return z + dn.to(z.dtype)


def moe_tail(p, a, x, cfg: GPTConfig, drop: float = 0.0, seeds=(0, 0),
             matmul=None):
    """Post-attention tail of an expert block (the reference's composed
    chain, no fused sub-blocks):

        x = x + dropout(a @ wo + bo)
        out = x + dropout(moe_ffn(LN2(x)))

    `matmul(a, wo)` overrides the out-projection's product (a tp rank
    passes its partial summed over tp). Returns (out, aux)."""
    from ..parallel.moe import moe_ffn
    cdt = a.dtype
    wo = p["wo"]
    prod = a @ wo.to(cdt) if matmul is None else matmul(a, wo)
    proj = _drop(prod + p["bo"].to(cdt), drop, seeds[0])
    x = x + proj.to(x.dtype)
    h = _ln(x, p["ln2_s"], p["ln2_b"], cfg.layer_norm_eps)
    y, aux = moe_ffn(h.to(cdt), p["wg"], p["we_up"], p["be_up"],
                     p["we_down"], p["be_down"],
                     capacity_factor=cfg.moe_capacity_factor,
                     top_k=cfg.moe_top_k)
    return x + _drop(y, drop, seeds[1]).to(x.dtype), aux


def gpt_block_fn(p: dict, x, cfg: GPTConfig, seeds=None):
    """One pre-LN decoder block on [B, T, D], with residual dropout at
    cfg.dropout from the two int32 `seeds` when they are given. Returns
    (x, aux): aux the block's MoE load-balance loss (None for a dense
    block)."""
    cdt = getattr(torch, cfg.amp_dtype) if cfg.amp_dtype else x.dtype

    def c(a):
        return a.to(cdt)

    h = _ln(x, p["ln1_s"], p["ln1_b"], cfg.layer_norm_eps)
    q = c(h) @ c(p["wq"]) + c(p["bq"])
    k = c(h) @ c(p["wk"]) + c(p["bk"])
    v = c(h) @ c(p["wv"]) + c(p["bv"])
    a = _causal_attention(q, k, v, cfg.num_heads, cfg.attn_impl)
    B, T, D = x.shape
    drop = cfg.dropout if seeds is not None else 0.0
    if cfg.num_experts > 0:
        return moe_tail(p, c(a), x, cfg, drop, seeds or (0, 0))
    return decoder_tail(p, c(a).reshape(B * T, D), x.reshape(B * T, D),
                        cfg, drop, seeds or (0, 0)).reshape(B, T, D), None


def _embed(params, ids, cfg: GPTConfig, pos0: int = 0):
    """wte[ids] + wpe[pos0 : pos0 + T] (pos0: the global position of a
    sequence shard's first token)."""
    T = pos0 + ids.shape[-1]
    if T > params["wpe"].shape[0]:
        raise ValueError(
            f"sequence length {T} exceeds max_position_embeddings="
            f"{params['wpe'].shape[0]}")
    ids = torch.as_tensor(ids, device=params["wte"].device).long()
    x = params["wte"][ids] + params["wpe"][pos0:T]
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
    """(h, blk, seeds=None) -> (h, aux) for one layer, recomputed in the
    backward when cfg.remat and autograd is recording (the reference's
    jax.checkpoint per layer); the seeds ride along, so the recompute
    drops the same elements."""
    def body(h, blk, seeds=None):
        if cfg.remat and torch.is_grad_enabled():
            return checkpoint(gpt_block_fn, blk, h, cfg, seeds,
                              use_reentrant=False)
        return gpt_block_fn(blk, h, cfg, seeds)
    return body


def gpt_forward_aux(params: dict, ids, cfg: GPTConfig, key=None):
    """(logits [B, T, V] float32, aux): aux is the MoE load-balance loss
    summed over the layers (0.0 for dense blocks). `key` (an int step
    seed) turns on dropout when cfg.dropout > 0."""
    x = _embed(params, ids, cfg)
    body = block_body(cfg)
    layers = _layers(params["blocks"])
    seeds = [None] * len(layers)
    if cfg.dropout and key is not None:
        with F.seed_scope(key):
            x = F.dropout(x, cfg.dropout, seed=F.next_seed())
            seeds = [(F.next_seed(), F.next_seed()) for _ in layers]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk, s in zip(layers, seeds):
        x, a = body(x, blk, s)
        if a is not None:
            aux = aux + a
    return _head(params, x, cfg), aux


def gpt_forward(params: dict, ids, cfg: GPTConfig, key=None):
    """ids [B, T] int -> logits [B, T, V] (float32)."""
    return gpt_forward_aux(params, ids, cfg, key)[0]


def gpt_loss(params: dict, ids, cfg: GPTConfig, logits=None, key=None):
    """Mean next-token cross entropy, as the reference computes it:
    logsumexp(logits) - gold logit, predicting ids[:, 1:] from
    ids[:, :-1]; MoE models add cfg.moe_aux_weight * aux. `key`: the
    step seed of the dropout masks."""
    aux = None
    if logits is None:
        logits, aux = gpt_forward_aux(params, ids, cfg, key)
    ids = torch.as_tensor(ids, device=logits.device).long()
    logits = logits[:, :-1]
    labels = ids[:, 1:]
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    loss = torch.mean(logz - gold)
    if aux is not None and cfg.num_experts > 0:
        loss = loss + cfg.moe_aux_weight * aux
    return loss

"""Decode-model adapter: the GPT core over a paged KV cache
(counterpart of ``paddle_tpu/serving/model.py``).

  prefill(params, cache, tokens [T], true_len, page_row [M])
      -> (cache, logits [V])
    Dense causal forward over one padded prompt bucket; per-layer K/V of
    every bucket position is written into the request's pages (padding
    positions land in the pool's trash page) and the logits of the LAST
    REAL position (true_len - 1) come back.

  prefill_tail(params, cache, tokens [T], start, true_len, page_row)
      -> (cache, logits [V])
    Prefill of the unmatched tail of a prompt whose first `start` tokens
    were found in the prefix cache: each tail position is computed like
    a decode step, through the paged-attention kernel.

  decode(params, cache, tokens [S], positions [S], tables [S, M])
      -> (cache, logits [S, V])
    One token for every slot of the fixed-shape slot batch.

The cache is a dict of two preallocated pools ``[L, num_pages+1, ps, H,
d]``; the last page is the trash page that absorbs masked writes. Unlike
the JAX package (``ck.at[...].set`` returns a new array), every cache
update here is an in-place ``index_put_`` into the pools, and the same
dict comes back. A step that fails part-way can therefore leave the
pools half-written; on a card the engine rebuilds them (engine.py
``_recover_cache``), as it does after a donated-buffer failure on a TPU.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..checkpoint import CheckpointStore, ShardedArray
from ..models.gpt import (GPTConfig, _causal_attention, _ln, decoder_tail,
                          disable_tf32, init_gpt_params, param_shapes,
                          params_from_jax, resolve_device)
from ..ops.paged_attention import (paged_attention_decode,
                                   paged_attention_reference)

__all__ = ["GPTDecodeModel"]


def _keystr(path) -> str:
    """A leaf's manifest key: its tree path as jax.tree_util.keystr
    writes it, ``['blocks']['wq']``."""
    return "".join(f"[{name!r}]" for name in path)


def _tree_items(params) -> list:
    """(path, leaf) of the port's parameters in the JAX package's
    flatten order (dict keys sorted at every level); a block leaf is the
    list of its L per-layer tensors."""
    out = []
    for name in sorted(params):
        if name == "blocks":
            blocks = params[name]
            out += [(("blocks", k), [b[k] for b in blocks])
                    for k in sorted(blocks[0])]
        else:
            out.append(((name,), params[name]))
    return out


def checkpoint_arrays(params) -> dict:
    """The store's view of the port's parameters: tree-path key ->
    array, in the JAX package's flatten order. A block leaf's per-layer
    tensors are the pieces of its stacked [L, ...] byte stream, so
    nothing is stacked on the card and the chunks equal those of the
    JAX package's stacked leaf."""
    return {_keystr(path): ShardedArray([t[None] for t in leaf])
            if isinstance(leaf, list) else leaf
            for path, leaf in _tree_items(params)}


def _paths(tree, prefix=()):
    """(path, leaf) of a JAX-layout tree of dicts, in flatten order."""
    for name in sorted(tree):
        if isinstance(tree[name], dict):
            yield from _paths(tree[name], prefix + (name,))
        else:
            yield prefix + (name,), tree[name]


def _prepare(arrays: dict, template, root: str, device):
    """The port's parameters on `device` from tree-path-keyed host
    arrays: one leaf per (path, dtype, shape) of `template`, cast to
    its dtype. A missing key raises KeyError naming it, a leaf of
    another shape ValueError. On a card the uploads run on a stream of
    their own, so the decode steps that an engine (or another engine in
    the process) enqueues on the default stream meanwhile do not wait
    behind the copies; they are complete when this returns, so adopting
    the result is a bare reference swap."""
    tree: dict = {}
    for path, dtype, shape in template:
        key = _keystr(path)
        if key not in arrays:
            raise KeyError(f"checkpoint under {root} is missing param "
                           f"{key}")
        arr = arrays[key]
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"checkpoint under {root}: param {key} has "
                             f"shape {tuple(arr.shape)}, the model "
                             f"{tuple(shape)}")
        node = tree
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = torch.from_numpy(arr).to(dtype)
    if device.type != "cuda":
        return params_from_jax(tree, device)
    side = torch.cuda.Stream(device)
    with torch.cuda.stream(side):
        params = params_from_jax(tree, device)
    side.synchronize()
    # the default stream reads them from the flip on: their blocks are
    # not handed out again until its work queued at their free is done
    default = torch.cuda.default_stream(device)
    for name, t in params.items():
        if name != "blocks":
            t.record_stream(default)
    for t in params["blocks"][0].values():
        t.record_stream(default)       # a layer's views share one base
    return params


class GPTDecodeModel:
    """Serving adapter around the GPT core.

    `params`: None (random weights from `seed`, bit-identical to the JAX
    package's), a JAX-layout pytree (stacked ``blocks``), or the port's
    own parameter dict (``blocks`` a list), used as it is. `attn_impl`:
    None runs the paged-attention kernel (its plain version for CPU
    tensors); "plain" pins the plain version, the counterpart of the
    JAX package's "xla". `device` defaults to CUDA and raises without a
    card unless the caller asks for "cpu"."""

    def __init__(self, cfg: GPTConfig, params=None, seed: int = 0,
                 attn_impl: str | None = None, device=None):
        if attn_impl not in (None, "plain"):
            raise ValueError(f"attn_impl must be None or 'plain', got "
                             f"{attn_impl!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        disable_tf32()
        if params is None:
            params = init_gpt_params(cfg, seed)
        if isinstance(params["blocks"], dict):
            params = params_from_jax(params, self.device)
        self.params = params
        self.head_dim = cfg.hidden_size // cfg.num_heads
        self.attn_impl = attn_impl
        self._attend = paged_attention_reference if attn_impl == "plain" \
            else paged_attention_decode
        # the engine caps admission at this (a position past wpe would
        # raise on the embedding lookup)
        self.max_positions = cfg.max_position_embeddings

    # -- checkpoint warm-start (paddle_tpu_torch.checkpoint) ------------
    # The manifest is the JAX package's, key for key: every leaf is keyed
    # by its JAX tree path (``['blocks']['wq']``, jax.tree_util.keystr)
    # with the blocks stacked [L, ...], so either package restores what
    # the other saved.
    def save_checkpoint(self, root: str, step: int | None = None) -> int:
        """Persist the parameters through the checkpoint store
        (content-addressed chunks; repeated saves of a mostly-unchanged
        model dedup). The config rides the manifest meta; no pickle."""
        return CheckpointStore(root).save(
            checkpoint_arrays(self.params), step=step,
            meta={"kind": "gpt-decode",
                  "cfg": dataclasses.asdict(self.cfg)})

    @classmethod
    def from_checkpoint(cls, root: str, step: int | None = None,
                        attn_impl: str | None = None,
                        cfg: GPTConfig | None = None,
                        device=None) -> "GPTDecodeModel":
        """Build a decode model from a committed manifest: the config
        rides the manifest meta (overridable), ``param_shapes(cfg)`` is
        the template, and every leaf is restored by its tree-path key.
        No random init is drawn. The serving engine's cold-start entry."""
        dev = resolve_device(device)
        arrays, meta = CheckpointStore(root).restore(step)
        if cfg is None:
            mcfg = (meta or {}).get("cfg")
            if not mcfg:
                raise ValueError(
                    f"manifest under {root} has no model config — pass "
                    f"cfg= explicitly")
            cfg = GPTConfig(**mcfg)
        template = [(path, torch.float32, shape)
                    for path, shape in _paths(param_shapes(cfg))]
        return cls(cfg, params=_prepare(arrays, template, root, dev),
                   attn_impl=attn_impl, device=dev)

    def read_checkpoint(self, root: str, step: int | None = None):
        """Disk + host->device phase of load_checkpoint: fetch the
        arrays AND build the complete replacement parameters on the
        model's device (dtype-cast against the live parameters) without
        touching them. Engine.warm_start runs this off the step lock so
        serving overlaps both the read and the upload; the
        adopt_checkpoint flip is then a pure reference swap."""
        arrays, _meta = CheckpointStore(root).restore(step)
        return self._prepare_params(arrays, root)

    def adopt_checkpoint(self, prepared) -> "GPTDecodeModel":
        """Flip phase: adopt parameters built by read_checkpoint /
        _prepare_params. One reference assignment — O(1) under the
        engine step lock, no disk, no host->device transfer."""
        self.params = prepared
        return self

    def load_checkpoint(self, root: str, step: int | None = None) \
            -> "GPTDecodeModel":
        """Swap this model's weights in place from a committed manifest
        (same structure required) — no throwaway model init."""
        return self.adopt_checkpoint(self.read_checkpoint(root, step))

    def _prepare_params(self, arrays: dict, root: str):
        """The replacement parameters from tree-path-keyed arrays, with
        the CURRENT parameters as template (read-only; safe concurrent
        with a live engine decoding on the old ones)."""
        template = []
        for path, leaf in _tree_items(self.params):
            if isinstance(leaf, list):
                template.append((path, leaf[0].dtype,
                                 (len(leaf),) + tuple(leaf[0].shape)))
            else:
                template.append((path, leaf.dtype, tuple(leaf.shape)))
        return _prepare(arrays, template, root, self.device)

    # -- cache ---------------------------------------------------------
    def init_cache(self, num_pages: int, page_size: int):
        """[L, num_pages+1, ps, H, d] zero pools (last page = trash)."""
        cfg = self.cfg
        dt = getattr(torch, cfg.amp_dtype) if cfg.amp_dtype \
            else torch.float32
        shape = (cfg.num_layers, num_pages + 1, page_size, cfg.num_heads,
                 self.head_dim)
        return {"k": torch.zeros(shape, dtype=dt, device=self.device),
                "v": torch.zeros(shape, dtype=dt, device=self.device)}

    def apply_defrag(self, cache, mapping: dict[int, int]):
        """Move live pages per defrag_plan's old->new mapping."""
        if not mapping:
            return cache
        P = cache["k"].shape[1]
        perm = list(range(P))
        for old, new in mapping.items():
            perm[new] = old
        perm = torch.as_tensor(perm, device=self.device)
        return {"k": cache["k"][:, perm].contiguous(),
                "v": cache["v"][:, perm].contiguous()}

    def copy_pages(self, cache, src, dst):
        """Copy page contents src[i] -> dst[i] across every layer pool
        (the copy-on-write step of a full-prompt bootstrap admission);
        in place."""
        src = torch.as_tensor(src, dtype=torch.long, device=self.device)
        dst = torch.as_tensor(dst, dtype=torch.long, device=self.device)
        for key in ("k", "v"):
            cache[key][:, dst] = cache[key][:, src]
        return cache

    # -- layer math ----------------------------------------------------
    def _qkv(self, p, h):
        q = h @ p["wq"] + p["bq"]
        k = h @ p["wk"] + p["bk"]
        v = h @ p["wv"] + p["bv"]
        return q, k, v

    def _logits(self, params, x):
        x = _ln(x, params["lnf_s"], params["lnf_b"], self.cfg.layer_norm_eps)
        return x.float() @ params["wte"].float().T

    # -- prefill -------------------------------------------------------
    def prefill(self, params, cache, tokens, true_len: int, page_row):
        """tokens [T] int (padded bucket), true_len int, page_row [M]
        int (fill = trash). Returns (cache, logits [V])."""
        cfg = self.cfg
        H, d = cfg.num_heads, self.head_dim
        T = tokens.shape[0]
        ps = cache["k"].shape[2]
        n_pages = T // ps
        pages = page_row[:n_pages].long()
        x = params["wte"][tokens.long()] + params["wpe"][:T]      # [T, D]
        ck, cv = cache["k"], cache["v"]
        for l, p in enumerate(params["blocks"]):
            h = _ln(x, p["ln1_s"], p["ln1_b"], cfg.layer_norm_eps)
            q, k, v = self._qkv(p, h)
            # in place (index_put_), where the JAX package builds a new
            # array with .at[l, pages].set
            ck[l, pages] = k.reshape(n_pages, ps, H, d).to(ck.dtype)
            cv[l, pages] = v.reshape(n_pages, ps, H, d).to(cv.dtype)
            a = _causal_attention(q[None], k[None], v[None], H,
                                  impl="xla")[0]
            x = decoder_tail(p, a, x, cfg)
        return cache, self._logits(params, x[int(true_len) - 1])

    # -- tail prefill (shared-prefix admission) ------------------------
    def prefill_tail(self, params, cache, tokens, start: int,
                     true_len: int, page_row):
        """Prefill ONLY the unmatched tail of a prompt whose first
        `start` tokens (page-aligned) are cached: tokens [T] (padded
        tail bucket), page_row [M] (matched + owned pages, fill =
        trash). Each tail position attends over the request's own
        history with ctx = position + 1, exactly like a decode step."""
        cfg = self.cfg
        H, d = cfg.num_heads, self.head_dim
        T = tokens.shape[0]
        ps = cache["k"].shape[2]
        n_pages = T // ps
        start = int(start)
        positions = start + torch.arange(T, dtype=torch.int32,
                                         device=self.device)
        x = params["wte"][tokens.long()] + params["wpe"][positions.long()]
        row = page_row.to(torch.int32)
        tables = row[None, :].expand(T, row.shape[0]).contiguous()
        ctx = (positions + 1).to(torch.int32)
        tail_pages = row[start // ps:start // ps + n_pages].long()
        ck, cv = cache["k"], cache["v"]
        for l, p in enumerate(params["blocks"]):
            h = _ln(x, p["ln1_s"], p["ln1_b"], cfg.layer_norm_eps)
            q, k, v = self._qkv(p, h)
            ck[l, tail_pages] = k.reshape(n_pages, ps, H, d).to(ck.dtype)
            cv[l, tail_pages] = v.reshape(n_pages, ps, H, d).to(cv.dtype)
            a = self._attend(q.reshape(T, H, d), ck[l], cv[l], tables, ctx,
                             1.0 / math.sqrt(d))
            x = decoder_tail(p, a.reshape(T, -1), x, cfg)
        return cache, self._logits(params, x[int(true_len) - 1])

    # -- decode --------------------------------------------------------
    def decode(self, params, cache, tokens, positions, tables):
        """tokens/positions [S] int, tables [S, M] int32 (fill = trash;
        inactive slots = all-trash rows with position 0). Returns
        (cache, logits [S, V])."""
        cfg = self.cfg
        H, d = cfg.num_heads, self.head_dim
        S = tokens.shape[0]
        ps = cache["k"].shape[2]
        pos = positions.long()
        x = params["wte"][tokens.long()] + params["wpe"][pos]       # [S, D]
        tables = tables.to(torch.int32).contiguous()
        page_of = torch.gather(tables.long(), 1, (pos // ps)[:, None])[:, 0]
        off = pos % ps
        ctx = (pos + 1).to(torch.int32)
        ck, cv = cache["k"], cache["v"]
        for l, p in enumerate(params["blocks"]):
            h = _ln(x, p["ln1_s"], p["ln1_b"], cfg.layer_norm_eps)
            q, k, v = self._qkv(p, h)
            ck[l, page_of, off] = k.reshape(S, H, d).to(ck.dtype)
            cv[l, page_of, off] = v.reshape(S, H, d).to(cv.dtype)
            a = self._attend(q.reshape(S, H, d), ck[l], cv[l], tables, ctx,
                             1.0 / math.sqrt(d))
            x = decoder_tail(p, a.reshape(S, -1), x, cfg)
        return cache, self._logits(params, x)

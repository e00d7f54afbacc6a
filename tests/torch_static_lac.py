"""The static LAC tagger (Baidu's lexical analysis net, PaddleNLP
``lexical_analysis`` ``lex_net``): a sparse word embedding, a two-layer
bidirectional GRU, an fc to the tag emissions, a linear-chain CRF for
the loss and Viterbi decoding for the path, trained by SGD with an
exponential moving average of the weights.

``build_lac_program`` takes the fluid namespace to build with (either
package's ``fluid`` and its top package, for enable_static), so that the
port's tests and ``chip_smoke.py`` build the same program in each
package. It imports neither package itself. ``lac_batch`` draws a
seeded batch whose tags depend on the words and on the previous tag.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np


@dataclasses.dataclass
class LacConfig:
    vocab: int = 20940          # LAC's character dictionary
    emb: int = 128
    hidden: int = 128
    layers: int = 2
    tags: int = 57
    batch: int = 300
    seq: int = 64
    min_len: int = 8
    # SGD's rate: at full width the largest of those tried on the CPU
    # (0.01 to 0.3) whose 20 steps on one batch stay stable
    lr: float = 0.07
    ema_decay: float = 0.999

    @classmethod
    def small(cls, **kw):
        """The CPU tests' size."""
        base = dict(vocab=200, emb=16, hidden=16, layers=2, tags=7, batch=4,
                    seq=12, min_len=3)
        base.update(kw)
        return cls(**base)


def build_lac_program(fluid, top, cfg: LacConfig):
    """The LAC program in `fluid` (a package's ``fluid`` module; `top`
    the package, whose enable_static / disable_static bracket the
    build). Returns a namespace: main, startup, the feed names (word,
    target, length), loss, path (crf_decoding's), ema, and the names of
    the embedding and transition parameters."""
    L = fluid.layers
    top.enable_static()
    try:
        with fluid.unique_name.guard():
            main, startup = fluid.Program(), fluid.Program()
            main.random_seed = startup.random_seed = 7
            with fluid.program_guard(main, startup):
                word = L.data("word", [-1, cfg.seq], "int64")
                target = L.data("target", [-1, cfg.seq], "int64")
                length = L.data("length", [-1], "int64")
                # LAC's init_bound: the embedding uniform in +-0.1
                emb = L.embedding(word, [cfg.vocab, cfg.emb], is_sparse=True,
                                  param_attr=fluid.ParamAttr(
                                      name="word_emb",
                                      initializer=fluid.initializer.Uniform(
                                          -0.1, 0.1)))
                enc, _ = L.dynamic_rnn(emb, cfg.hidden, mode="GRU",
                                       num_layers=cfg.layers,
                                       is_bidirec=True,
                                       sequence_length=length)
                emission = L.fc(enc, cfg.tags, num_flatten_dims=2)
                ll = L.linear_chain_crf(
                    emission, target, length=length,
                    param_attr=fluid.ParamAttr(name="crfw"))
                loss = L.mean(L.scale(ll, -1.0))
                crfw = main.global_block().var("crfw")
                path = L.crf_decoding(emission, transition=crfw,
                                      length=length)
                fluid.optimizer.SGD(learning_rate=cfg.lr).minimize(loss)
                ema = fluid.optimizer.ExponentialMovingAverage(cfg.ema_decay)
                ema.update()
    finally:
        top.disable_static()
    return SimpleNamespace(main=main, startup=startup,
                           feeds=("word", "target", "length"), loss=loss,
                           path=path, ema=ema, emb="word_emb",
                           transition="crfw")


def lac_batch(cfg: LacConfig, seed: int = 0) -> dict:
    """A seeded batch: lengths uniform in [min_len, seq]; word ids drawn
    Zipf-like (a few frequent characters, a long tail) from 1..vocab-1,
    0 past each length; a word's tag is its own (a fixed random table)
    unless the word is a continuation character (a quarter of the
    vocabulary), which takes the previous tag plus one; 0 past each
    length."""
    r = np.random.RandomState(seed)
    B, T, V, N = cfg.batch, cfg.seq, cfg.vocab, cfg.tags
    table = np.random.RandomState(1000 + V).randint(0, N, V)
    cont = np.random.RandomState(2000 + V).rand(V) < 0.25
    length = r.randint(cfg.min_len, T + 1, B).astype(np.int64)
    rank = np.arange(1, V)
    p = 1.0 / rank
    word = r.choice(rank, size=(B, T), p=p / p.sum()).astype(np.int64)
    target = np.zeros((B, T), np.int64)
    for t in range(T):
        prev = target[:, t - 1] if t else np.zeros(B, np.int64)
        w = word[:, t]
        target[:, t] = np.where(cont[w], (prev + 1) % N, table[w])
    live = np.arange(T)[None, :] < length[:, None]
    return {"word": np.where(live, word, 0),
            "target": np.where(live, target, 0), "length": length}

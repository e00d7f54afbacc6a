"""wide&deep CTR model in PyTorch (counterpart of
``paddle_tpu/models/wide_deep.py``, BASELINE config 4).

Parameters are a plain dictionary of tensors in the JAX package's layout
(``mlp`` a list of ``{"w": (Din, Dout), "b"}``), drawn by the same numpy
calls in the same order, so both packages start from bit-identical
weights for a seed. The lookup is a dense gather (``F.embedding``): its
gradient is the whole table with the looked-up rows accumulated, as
``jnp.take``'s is, and the train step runs the port's dense ``adam`` on
every leaf, so every row's moments decay each step as in the JAX
package. No kernel of the port lies on this path: the MLP's products are
plain matrix products, as they were for XLA.

Over a ``("dp", "mp")`` mesh (one process a rank, as the JAX package's
device mesh): the batch's rows over dp, both tables row-sharded over mp
with the collective lookup (``parallel/embedding.py``), the dense tower
replicated over mp (so its gradients are not summed over mp), every
gradient averaged over dp, and each rank's Adam on its slice of each
table.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..fluid.ops.optimizer_ops import adam
from .gpt import disable_tf32, resolve_device

_TABLES = ("embed", "wide")

__all__ = ["WideDeepConfig", "init_widedeep_params", "params_from_numpy",
           "widedeep_forward", "widedeep_loss", "WideDeepTrainStep"]


@dataclasses.dataclass
class WideDeepConfig:
    """Criteo-style: `num_slots` categorical slots hashed into one unified
    vocab + `dense_dim` continuous features."""
    vocab_size: int = 1024 * 1024
    num_slots: int = 26
    embed_dim: int = 16
    dense_dim: int = 13
    hidden: tuple = (400, 400, 400)
    init_std: float = 0.01

    @classmethod
    def tiny(cls):
        return cls(vocab_size=4096, num_slots=8, embed_dim=8, dense_dim=4,
                   hidden=(32, 16))


def init_widedeep_params(cfg: WideDeepConfig, seed: int = 0) -> dict:
    """Numpy tree, bit-identical to the JAX package's for the same seed."""
    rng = np.random.RandomState(seed)
    n = lambda *s: rng.normal(0, cfg.init_std, s).astype(np.float32)
    widths = [cfg.num_slots * cfg.embed_dim + cfg.dense_dim, *cfg.hidden, 1]
    mlp = []
    for a, b in zip(widths[:-1], widths[1:]):
        mlp.append({"w": (rng.normal(0, np.sqrt(2.0 / a), (a, b))
                          .astype(np.float32)),
                    "b": np.zeros((b,), np.float32)})
    return {
        "embed": n(cfg.vocab_size, cfg.embed_dim),   # deep table
        "wide": n(cfg.vocab_size, 1),                # wide (linear) table
        "wide_dense": n(cfg.dense_dim, 1),
        "bias": np.zeros((1,), np.float32),
        "mlp": mlp,
    }


def params_from_numpy(tree: dict, device="cpu") -> dict:
    """The port's parameters from a JAX-layout tree (``init_widedeep_params``
    output or the JAX step's ``params``; leaves numpy or anything
    ``np.asarray`` takes), as float32 tensors on `device`."""
    dev = torch.device(device)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32)).to(dev)

    out = {k: t(v) for k, v in tree.items() if k != "mlp"}
    out["mlp"] = [{k: t(v) for k, v in layer.items()}
                  for layer in tree["mlp"]]
    return out


def _leaves(tree: dict) -> list:
    """The leaves in the JAX package's flatten order: sorted keys, the
    ``mlp`` list in layer order (``bias, embed, mlp[0].b, mlp[0].w, ...,
    wide, wide_dense``)."""
    out = []
    for k in sorted(tree):
        if k == "mlp":
            out += [layer[n] for layer in tree[k] for n in sorted(layer)]
        else:
            out.append(tree[k])
    return out


def _unflatten(like: dict, leaves: list) -> dict:
    it = iter(leaves)
    out = {}
    for k in sorted(like):
        if k == "mlp":
            out[k] = [{n: next(it) for n in sorted(layer)}
                      for layer in like[k]]
        else:
            out[k] = next(it)
    return out


def widedeep_forward(params: dict, sparse_ids, dense, cfg: WideDeepConfig,
                     lookup=None):
    """sparse_ids [B, S] int, dense [B, F] -> logits [B, 1].

    `lookup(table, ids) -> [B, S, dim]` defaults to a dense gather
    (``F.embedding``, whose gradient is dense)."""
    take = lookup or (lambda t, i: F.embedding(i, t))
    emb = take(params["embed"], sparse_ids)          # [B, S, D]
    wide_rows = take(params["wide"], sparse_ids)     # [B, S, 1]
    B = sparse_ids.shape[0]
    h = torch.cat([emb.reshape(B, -1), dense], dim=-1)
    for i, layer in enumerate(params["mlp"]):
        h = torch.addmm(layer["b"], h, layer["w"])
        if i < len(params["mlp"]) - 1:
            h = torch.relu(h)
    wide = wide_rows.sum(1) + dense @ params["wide_dense"]
    return h + wide + params["bias"]


def widedeep_loss(params, sparse_ids, dense, label, cfg, lookup=None):
    """Mean sigmoid BCE-with-logits, in the JAX package's arithmetic:
    max(z, 0) - z y + log1p(exp(-|z|))."""
    z = widedeep_forward(params, sparse_ids, dense, cfg, lookup)
    lab = label.float().reshape(z.shape)
    return torch.mean(torch.clamp_min(z, 0) - z * lab
                      + torch.log1p(torch.exp(-torch.abs(z))))


class WideDeepTrainStep:
    """step(sparse_ids, dense, label) -> loss: the loss and its gradients
    (dense, tables included), then the port's ``adam`` on every leaf in
    the JAX package's leaf order, each with the same pair of beta powers
    before the step. `lr` may be a callable, read once a step. Inputs
    may be numpy arrays or tensors; they are moved to the step's device.
    `device` defaults to CUDA and raises without a card unless the
    caller asks for "cpu".

    On one rank ``params`` and ``opt_state`` (a ``{"m1", "m2"}`` dict
    per leaf, float32) are updated in place and keep the JAX package's
    tree layout. Over a ``("dp", "mp")`` mesh (``mesh``, a
    ``distributed.mesh.Mesh``, or ``Mesh({"dp": dp, "mp": mp})`` over
    the world) every rank is called with the same global batch (B must
    divide by dp) and returns the global loss; ``local_params`` /
    ``local_opt_state`` hold its pieces (the tables' rows [i V/mp,
    (i+1) V/mp) of its mp coordinate i), and ``params`` / ``opt_state``
    gather the reference's whole tree (collective: every rank reads
    them). ``last_stats`` holds a step's host seconds in the lookup's
    all-reduce ("mp_s") and the dp gradient average ("dp_s")."""

    def __init__(self, cfg: WideDeepConfig, mesh=None, dp: int = 1,
                 mp: int = 1, lr=1e-3, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, seed: int = 0, device=None):
        from ..distributed.mesh import Mesh
        from ..parallel.comm import Comm
        from ..parallel.embedding import shard_rows
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a paddle_tpu_torch.distributed."
                            f"mesh.Mesh, got {type(mesh).__name__}")
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else Mesh({"dp": dp, "mp": mp})
        self.dp, self.mp = (self.mesh.axis_size(a) for a in ("dp", "mp"))
        self.device = resolve_device(device)
        disable_tf32()
        self._lr = lr
        self._hyper = dict(beta1=beta1, beta2=beta2, epsilon=epsilon)
        self.comm = Comm()
        self.last_stats: dict = {}
        tree = init_widedeep_params(cfg, seed)
        for k in _TABLES:
            tree[k] = shard_rows(tree[k], self.mesh, "mp")
        self.local_params = params_from_numpy(tree, self.device)
        self.local_opt_state = _unflatten(self.local_params, [
            {"m1": torch.zeros_like(p), "m2": torch.zeros_like(p)}
            for p in _leaves(self.local_params)])
        self._pows = (torch.ones(1, device=self.device),
                      torch.ones(1, device=self.device))

    def _whole(self, t):
        """A table's (or its moment's) rows gathered over mp."""
        from ..distributed.collective import all_gather
        return torch.cat(all_gather([], t, group=self.mesh.group("mp")), 0)

    @property
    def params(self) -> dict:
        if self.mp == 1:
            return self.local_params
        return {**self.local_params, **{
            k: self._whole(self.local_params[k]) for k in _TABLES}}

    @property
    def opt_state(self) -> dict:
        if self.mp == 1:
            return self.local_opt_state
        return {**self.local_opt_state, **{
            k: {n: self._whole(v) for n, v in
                self.local_opt_state[k].items()} for k in _TABLES}}

    def _lookup(self):
        if self.mp == 1:
            return None
        from ..parallel.embedding import sharded_embedding_lookup
        return lambda t, i: sharded_embedding_lookup(
            t, i, self.mesh, "mp", self.comm)

    def _tensor(self, a, dtype=None):
        t = a if isinstance(a, torch.Tensor) else torch.as_tensor(
            np.asarray(a))
        return t.to(self.device, dtype) if dtype else t.to(self.device)

    def _rows(self, a):
        if self.dp == 1:
            return a
        B = a.shape[0]
        if B % self.dp:
            raise ValueError(f"batch {B} not divisible by dp={self.dp}")
        b = B // self.dp
        r = self.mesh.coord("dp")
        return a[r * b:(r + 1) * b]

    def __call__(self, sparse_ids, dense, label):
        from ..distributed.parallel import all_reduce_buckets
        ids, dense, label = (self._rows(a) for a in (sparse_ids, dense,
                                                      label))
        ids = self._tensor(ids, torch.long)
        dense = self._tensor(dense, torch.float32)
        label = self._tensor(label)
        self.comm.reset()
        leaves = _leaves(self.local_params)
        live = [p.detach().requires_grad_() for p in leaves]
        loss = widedeep_loss(_unflatten(self.local_params, live), ids,
                             dense, label, self.cfg, self._lookup())
        grads = list(torch.autograd.grad(loss, live))
        loss = loss.detach()
        if self.dp > 1:
            group = self.mesh.group("dp")
            with self.comm.timed("dp", loss):
                all_reduce_buckets(grads, group=group, scale=1.0 / self.dp)
            loss = self.comm.all_reduce(loss.reshape(1), group,
                                        "dp")[0] / self.dp
        lr = self._lr() if callable(self._lr) else self._lr
        # the JAX step carries lr as a float32 array
        lr = float(np.float32(lr))
        b1p, b2p = self._pows
        with torch.no_grad():
            for p, g, st in zip(leaves, grads,
                                _leaves(self.local_opt_state)):
                b1n, b2n = adam(p, g, st["m1"], st["m2"], b1p, b2p, lr,
                                **self._hyper)
        self._pows = (b1n, b2n)
        self.last_stats = {f"{k}_s": v for k, v in self.comm.seconds.items()}
        return loss

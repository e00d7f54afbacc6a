"""FleetWrapper facade + Downpour async worker over the PS/KV tier
(counterpart of ``paddle_tpu/distributed/fleet/fleet_wrapper.py``).

Reference counterparts:
  framework/fleet/fleet_wrapper.h:60  — PullSparseVarsSync /
    PushSparseVarsWithLabelAsync / PullDenseVarsSync / PushDenseVarsAsync
    / SaveModel / LoadModel over pslib
  framework/device_worker.h:246       — DownpourWorker: per-thread loop
    pulling the batch's sparse rows, computing fwd/bwd, pushing grads
    asynchronously while other threads keep training

Pulls and pushes run host-side against the TCP PSClient (or in-process
LargeScaleKV tables in local mode), over the fault-tolerant transport of
``runtime/rpc.py`` (client retries with stable request ids; the shard
dedups, so a retried push applies exactly once). The worker's local step
— the wide&deep forward and backward over the pulled rows — runs on the
card (``device``, CUDA unless the caller names another).
"""
from __future__ import annotations

import queue
import threading
import time

import numpy as np

from .runtime.parameter_server_runtime import LargeScaleKV, PSClient

__all__ = ["FleetWrapper", "DownpourWorker"]


class FleetWrapper:
    """pull/push sparse + dense, save/load — the fleet_wrapper.h surface
    over PSClient (distributed) or in-process tables (local mode)."""

    def __init__(self, endpoints=None):
        self._client = PSClient(list(endpoints)) if endpoints else None
        self._local: dict[str, LargeScaleKV] = {}
        self.scale_sparse_gradient_with_batch_size = True

    @classmethod
    def from_role_maker(cls, role_maker):
        return cls(role_maker.get_pserver_endpoints())

    # -- sparse ---------------------------------------------------------
    def _table(self, name: str, dim: int,
               init_std: float = 0.01) -> LargeScaleKV:
        if name not in self._local:
            self._local[name] = LargeScaleKV(dim, init_std=init_std)
        return self._local[name]

    def pull_sparse(self, table: str, ids, dim: int,
                    init_std: float = 0.01) -> np.ndarray:
        """ids [N] -> rows [N, dim] (creating untouched rows with the
        table's initializer — large_scale_kv init-on-first-touch)."""
        ids = np.asarray(ids, np.int64).ravel()
        if self._client is not None:
            return self._client.pull(table, dim, ids, init_std=init_std)
        return self._table(table, dim, init_std).pull(ids)

    def push_sparse(self, table: str, ids, grads, dim: int,
                    lr: float = 1.0, init_std: float = 0.01):
        """Async apply-on-arrival: server does rows -= lr * grads
        (duplicate ids accumulate, reference PushSparseVarsAsync)."""
        ids = np.asarray(ids, np.int64).ravel()
        grads = np.asarray(grads, np.float32).reshape(len(ids), dim)
        if self._client is not None:
            self._client.push(table, dim, ids, grads, lr,
                              init_std=init_std)
        else:
            self._table(table, dim, init_std).push(ids, grads, lr)

    # -- dense ----------------------------------------------------------
    # a dense param is a KV table keyed 0..rows-1 with ZERO init (the
    # worker seeds the real init once via push_initial_dense)
    def pull_dense(self, name: str, shape) -> np.ndarray:
        shape = tuple(shape)
        m = shape[0] if len(shape) > 1 else 1
        dim = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
        rows = self.pull_sparse(name, np.arange(m), dim, init_std=0.0)
        return rows.reshape(shape)

    def push_dense(self, name: str, grad: np.ndarray, lr: float = 1.0):
        g = np.asarray(grad, np.float32)
        m = g.shape[0] if g.ndim > 1 else 1
        self.push_sparse(name, np.arange(m), g.reshape(m, -1),
                         g.reshape(m, -1).shape[1], lr, init_std=0.0)

    # -- lifecycle ------------------------------------------------------
    def save_model(self, dirname: str, mode=0):
        if self._client is not None:
            self._client.save(dirname)
        else:
            import os
            os.makedirs(dirname, exist_ok=True)
            for name, t in self._local.items():
                t.save(f"{dirname}/{name}.local.kv")

    def load_model(self, dirname: str, mode=0):
        import glob
        import os
        for path in glob.glob(f"{dirname}/*.local.kv"):
            # strip ONLY the fixed suffix: table names may contain dots
            # (dense tables like "mlp0.w")
            name = os.path.basename(path)[:-len(".local.kv")]
            t = LargeScaleKV(1)
            t.load(path)
            self._local[name] = t

    def table_size(self, table: str) -> int:
        if self._client is not None:
            return self._client.size(table)
        t = self._local.get(table)
        return 0 if t is None else t.size()

    def transport_stats(self) -> dict:
        """Retry/timeout/reconnect counters from the PS transport
        (empty in local mode) — the robustness tests and benchmarks
        assert against these."""
        return self._client.stats.as_dict() \
            if self._client is not None else {}

    def stop(self):
        if self._client is not None:
            self._client.close()


class DownpourWorker:
    """Async multi-thread worker loop for wide&deep-style CTR jobs
    (reference DownpourWorker::TrainFiles): each thread pulls the batch's
    touched sparse rows, runs the local forward and backward on the card,
    and pushes grads back (server applies on arrival — Downpour/async-SGD
    semantics).

    The local step reuses ``models/wide_deep.py``'s ``widedeep_loss``:
    the pulled unique-row matrices stand in for the full tables and the
    ids are remapped onto them, so the same forward serves PS mode and
    the mesh-sharded mode. Host logic (the unique ids, their
    power-of-two bucket, the pulls and the pushes in their order) is the
    JAX package's, so both send the same keys and the same wire bytes.
    `device` defaults to CUDA and raises without a card unless the
    caller asks for "cpu". ``timings`` holds each step's seconds in the
    pulls, the local step (CUDA events on the card: uploads, forward,
    backward and the gradients' copies to the host) and the pushes."""

    def __init__(self, fleet_wrapper: FleetWrapper, cfg, lr: float = 1e-2,
                 seed: int = 0, device=None):
        from ...models.gpt import disable_tf32, resolve_device
        from ...models.wide_deep import init_widedeep_params
        self.fw = fleet_wrapper
        self.cfg = cfg
        self.lr = lr
        self.device = resolve_device(device)
        disable_tf32()
        self._lock = threading.Lock()
        self._steps = 0
        self._losses: list[float] = []
        self.timings: list[dict] = []
        # dense-side init pushed once from a seeded init so every worker
        # and the server agree (reference InitServer dense push)
        ref = init_widedeep_params(cfg, seed)
        self._dense_names = ["wide_dense", "bias"] + \
            [f"mlp{i}.{k}" for i in range(len(ref["mlp"]))
             for k in ("w", "b")]
        self._ref = ref

    def _dense_params(self):
        p = {"wide_dense": self.fw.pull_dense(
                 "wide_dense", self._ref["wide_dense"].shape),
             "bias": self.fw.pull_dense("bias", self._ref["bias"].shape),
             "mlp": []}
        for i, layer in enumerate(self._ref["mlp"]):
            p["mlp"].append(
                {"w": self.fw.pull_dense(f"mlp{i}.w", layer["w"].shape),
                 "b": self.fw.pull_dense(f"mlp{i}.b", layer["b"].shape)})
        return p

    def push_initial_dense(self):
        """Rank-0: seed the server's dense tables with the reference
        init (server rows otherwise start from the KV initializer)."""
        self.fw.push_dense("wide_dense",
                           -self._ref["wide_dense"], lr=1.0)
        self.fw.push_dense("bias", -self._ref["bias"], lr=1.0)
        for i, layer in enumerate(self._ref["mlp"]):
            self.fw.push_dense(f"mlp{i}.w", -layer["w"], lr=1.0)
            self.fw.push_dense(f"mlp{i}.b", -layer["b"], lr=1.0)

    def _local_step(self, tree: dict, ids_local, dense, label):
        """Loss and every leaf's gradient (host numpy, in the tree's
        layout) on the worker's device."""
        import torch

        from ...models.wide_deep import (_leaves, _unflatten,
                                         params_from_numpy, widedeep_loss)
        dev = self.device
        params = params_from_numpy(tree, dev)
        leaves = _leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = widedeep_loss(
            params, torch.as_tensor(ids_local, device=dev),
            torch.as_tensor(np.asarray(dense, np.float32), device=dev),
            torch.as_tensor(np.asarray(label, np.float32), device=dev),
            self.cfg)
        grads = torch.autograd.grad(loss, leaves)
        g = _unflatten(params, [x.detach().cpu().numpy() for x in grads])
        return float(loss.detach()), g

    def train_one_batch(self, ids, dense, label) -> float:
        cfg = self.cfg
        ids = np.asarray(ids, np.int64)
        B, S = ids.shape
        t0 = time.perf_counter()
        uids, inv = np.unique(ids.ravel(), return_inverse=True)
        # pad the unique-id set to a power-of-two bucket, as the JAX
        # package does for its jitted step (pad rows repeat uids[0];
        # nothing indexes them, so their grads are exactly zero): the
        # pushes carry the same keys and bytes as the reference's
        bucket = 1 << max(int(np.ceil(np.log2(max(len(uids), 1)))), 3)
        bucket = min(bucket, B * S)
        if bucket > len(uids):
            uids = np.concatenate(
                [uids, np.full(bucket - len(uids), uids[0], np.int64)])
        emb_rows = self.fw.pull_sparse("embed", uids, cfg.embed_dim)
        wide_rows = self.fw.pull_sparse("wide", uids, 1)
        params = self._dense_params()
        params["embed"] = emb_rows
        params["wide"] = wide_rows
        ids_local = inv.reshape(B, S).astype(np.int64)
        t1 = time.perf_counter()
        if self.device.type == "cuda":
            import torch
            marks = [torch.cuda.Event(enable_timing=True)
                     for _ in range(2)]
            marks[0].record()
            lv, g = self._local_step(params, ids_local, dense, label)
            marks[1].record()
            marks[1].synchronize()
            local_s = marks[0].elapsed_time(marks[1]) / 1e3
        else:
            lv, g = self._local_step(params, ids_local, dense, label)
            local_s = time.perf_counter() - t1
        t2 = time.perf_counter()
        self.fw.push_sparse("embed", uids, g["embed"], cfg.embed_dim,
                            self.lr)
        self.fw.push_sparse("wide", uids, g["wide"], 1, self.lr)
        self.fw.push_dense("wide_dense", g["wide_dense"], self.lr)
        self.fw.push_dense("bias", g["bias"].reshape(1, -1), self.lr)
        for i, layer in enumerate(g["mlp"]):
            self.fw.push_dense(f"mlp{i}.w", layer["w"], self.lr)
            self.fw.push_dense(f"mlp{i}.b", layer["b"].reshape(1, -1),
                               self.lr)
        t3 = time.perf_counter()
        with self._lock:
            self._steps += 1
            self._losses.append(lv)
            self.timings.append({"pull_s": t1 - t0, "local_s": local_s,
                                 "push_s": t3 - t2, "step_s": t3 - t0})
        return lv

    def train_from_dataset(self, batches, thread_num: int = 2):
        """Drain `batches` (iterable of (ids, dense, label)) with
        `thread_num` concurrent worker threads (reference
        trainer_desc thread_num + DownpourWorker::TrainFiles loop)."""
        q: queue.Queue = queue.Queue(maxsize=2 * thread_num)
        stop = object()
        errs: list[BaseException] = []

        def run():
            while True:
                item = q.get()
                if item is stop:
                    return
                try:
                    self.train_one_batch(*item)
                except BaseException as e:  # surfaced to the caller
                    errs.append(e)
                    return

        threads = [threading.Thread(target=run, daemon=True)
                   for _ in range(thread_num)]
        for t in threads:
            t.start()
        for b in batches:
            # bounded queue: if every worker died on an error the
            # producer must stop instead of blocking on q.put forever
            while True:
                if errs and not any(t.is_alive() for t in threads):
                    break
                try:
                    q.put(b, timeout=0.5)
                    break
                except queue.Full:
                    continue
            if errs and not any(t.is_alive() for t in threads):
                break
        for _ in threads:
            while True:
                try:
                    q.put(stop, timeout=0.5)
                    break
                except queue.Full:
                    if not any(t.is_alive() for t in threads):
                        break
        for t in threads:
            t.join()
        if errs:
            raise errs[0]
        return list(self._losses)

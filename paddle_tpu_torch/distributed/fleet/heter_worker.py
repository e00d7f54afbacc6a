"""Heterogeneous PS training tier: CPU sparse workers + a dense worker on
the card (counterpart of ``paddle_tpu/distributed/fleet/heter_worker.py``).

The reference's heterogeneous trainer stack — HeterWrapper
(paddle/fluid/framework/fleet/heter_wrapper.h:54), the heter service
tensor RPC (framework/heter_service.h) and HeterXpuTrainer
(framework/trainer.h:149) — splits a CTR job so cheap host-CPU machines
run IO + embedding lookup while accelerator workers run the dense net,
exchanging activations/gradients over an RPC bridge:

  HeterCpuWorker  (role "cpu", N processes)
      owns the SPARSE tier — pulls embedding rows from the PS/KV
      (TCP PSClient or in-process LargeScaleKV), gathers + flattens the
      batch's sparse features host-side, ships the activation bundle to
      the dense worker, receives activation gradients back, scatters
      them into per-row sparse grads and pushes them to the PS.

  HeterDenseWorker  (role "device", 1 process)
      owns the DENSE net on the card: the forward and backward with
      gradients for the parameters AND the incoming activations, local
      SGD on the dense parameters (kept on the card), and (loss, d_emb,
      d_wide) back to the requesting CPU worker. Serves all CPU workers
      concurrently over the same fault-tolerant transport the PS tier
      uses (async/Downpour semantics: no cross-worker barrier).

The wire is runtime/rpc.py's data-only framing (no pickle on the
receive path; optional PADDLE_PS_SECRET handshake), byte-identical to
the JAX package's, so the whole topology (PS shards + dense worker + N
cpu workers) is plain TCP — and a retried "step" is applied exactly once
(the dense server dedups request ids, so a reply lost to the network
cannot double-apply an SGD update).
"""
from __future__ import annotations

import socketserver
import threading
import time

import numpy as np

from .runtime.parameter_server_runtime import LargeScaleKV, PSClient
from .runtime.rpc import RpcClient, RpcServerState, serve_connection

__all__ = ["HeterDenseWorker", "HeterCpuWorker"]


def dense_loss(params, emb_flat, wide_sum, dense, label):
    """The dense side of wide&deep in the JAX package's arithmetic:
    concat, the MLP with relu, the wide sum, mean BCE-with-logits as
    max(z, 0) - z y + log1p(exp(-|z|))."""
    import torch
    h = torch.cat([emb_flat, dense], dim=-1)
    for i, layer in enumerate(params["mlp"]):
        h = h @ layer["w"] + layer["b"]
        if i < len(params["mlp"]) - 1:
            h = torch.relu(h)
    z = h + wide_sum + dense @ params["wide_dense"] + params["bias"]
    lab = label.float().reshape(z.shape)
    return torch.mean(torch.clamp_min(z, 0) - z * lab
                      + torch.log1p(torch.exp(-torch.abs(z))))


class HeterDenseWorker(socketserver.ThreadingTCPServer):
    """Accelerator-side dense trainer (HeterXpuTrainer parity).

    Protocol (request -> reply):
      {"op": "step", "emb": [B,S*D], "wide": [B,1], "dense": [B,F],
       "label": [B,1]}
          -> {"loss": float, "d_emb": [B,S*D], "d_wide": [B,1]}
      {"op": "params"} -> {"mlp": ..., "wide_dense": ..., "bias": ...}
      {"op": "stop"} -> {"ok": True}

    `device` defaults to CUDA and raises without a card unless the
    caller asks for "cpu". ``step_seconds`` holds each step's seconds on
    the device (CUDA events on the card: uploads, forward, backward,
    update and the replies' copies to the host)."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, cfg, endpoint: str = "127.0.0.1:0",
                 lr: float = 1e-2, seed: int = 0, device=None):
        from ...models.gpt import disable_tf32, resolve_device
        from ...models.wide_deep import init_widedeep_params, \
            params_from_numpy

        host, port = endpoint.rsplit(":", 1)
        self.cfg = cfg
        self.lr = lr
        self.device = resolve_device(device)
        disable_tf32()
        ref = init_widedeep_params(cfg, seed)
        # the dense parameters live on the device; an update replaces
        # each tensor (never in place), so a step's snapshot of the
        # dict stays valid while other steps apply theirs
        self.params = params_from_numpy(
            {"mlp": ref["mlp"], "wide_dense": ref["wide_dense"],
             "bias": ref["bias"]}, self.device)
        self._plock = threading.Lock()
        self.losses: list[float] = []
        self.step_seconds: list[float] = []
        self._stop = threading.Event()

        # "params" is the only read op; "step"/"stop" mutate and are
        # deduped by request id (exactly-once across client retries)
        self._rpc = RpcServerState(read_ops={"params", "ping"})
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                serve_connection(self.request, outer._dispatch,
                                 outer._rpc)

        super().__init__((host, int(port)), Handler)

    @property
    def endpoint(self) -> str:
        return f"{self.server_address[0]}:{self.server_address[1]}"

    def _dispatch(self, req: dict) -> dict:
        op = req.get("op")
        if op == "step":
            return self._step(req)
        if op == "params":
            return self.host_params()
        if op == "stop":
            self._stop.set()
            threading.Thread(target=self.shutdown, daemon=True).start()
            return {"ok": True}
        if op == "ping":
            return "pong"
        raise ValueError(f"unknown heter op {op!r}")

    def host_params(self) -> dict:
        """The dense parameters as host numpy, in the reply layout."""
        with self._plock:
            p = self.params
        return {"mlp": [{k: v.cpu().numpy() for k, v in layer.items()}
                        for layer in p["mlp"]],
                "wide_dense": p["wide_dense"].cpu().numpy(),
                "bias": p["bias"].cpu().numpy()}

    def step(self, emb, wide, dense, label):
        """One dense step: (loss, d_emb, d_wide) as host values, the
        parameters updated."""
        import torch

        from ...models.wide_deep import _leaves, _unflatten
        dev = self.device
        cuda = dev.type == "cuda"
        if cuda:
            marks = [torch.cuda.Event(enable_timing=True)
                     for _ in range(2)]
            marks[0].record()
        else:
            t0 = time.perf_counter()
        ins = [torch.as_tensor(np.require(a, np.float32, ("C", "W")),
                               device=dev)
               for a in (emb, wide, dense, label)]
        with self._plock:
            snap = self.params
        leaves = [p.detach().requires_grad_(True) for p in _leaves(snap)]
        emb_t = ins[0].requires_grad_(True)
        wide_t = ins[1].requires_grad_(True)
        loss = dense_loss(_unflatten(snap, leaves), emb_t, wide_t, ins[2],
                          ins[3])
        *gp, d_emb, d_wide = torch.autograd.grad(loss,
                                                 leaves + [emb_t, wide_t])
        with self._plock:
            # local SGD on the dense side (the reference's device-side
            # optimizer in HeterXpuTrainer); sparse updates happen on
            # the CPU/PS side. The delta applies to the CURRENT params,
            # not the pre-grad snapshot — concurrent workers' updates
            # compose (Hogwild) instead of overwriting each other.
            cur = self.params
            self.params = _unflatten(cur, [
                p - self.lr * g for p, g in zip(_leaves(cur), gp)])
        out = (float(loss.detach()), d_emb.cpu().numpy(),
               d_wide.cpu().numpy())
        if cuda:
            marks[1].record()
            marks[1].synchronize()
            secs = marks[0].elapsed_time(marks[1]) / 1e3
        else:
            secs = time.perf_counter() - t0
        with self._plock:
            self.losses.append(out[0])
            self.step_seconds.append(secs)
        return out

    def _step(self, req: dict) -> dict:
        loss, d_emb, d_wide = self.step(req["emb"], req["wide"],
                                        req["dense"], req["label"])
        return {"loss": loss, "d_emb": d_emb, "d_wide": d_wide}

    def serve_in_thread(self) -> threading.Thread:
        th = threading.Thread(target=self.serve_forever, daemon=True)
        th.start()
        return th


class HeterCpuWorker:
    """Host-CPU sparse worker (reference HeterCpuWorker +
    HeterWrapper::SerializeToReq): embedding IO against the PS tier,
    dense compute delegated to a HeterDenseWorker over TCP."""

    def __init__(self, cfg, dense_endpoint: str,
                 ps_endpoints: list[str] | None = None,
                 lr: float = 1e-2, init_std: float = 0.01):
        self.cfg = cfg
        self.lr = lr
        self.init_std = init_std
        if ps_endpoints:
            self._kv = PSClient(ps_endpoints)
        else:
            self._local: dict[str, LargeScaleKV] = {}
            self._kv = None
        # fault-tolerant channel to the dense tier: retries/reconnects
        # with a stable request id, deduped server-side, so a lost
        # reply never double-applies a dense SGD step
        self._dense = RpcClient(dense_endpoint)
        self.losses: list[float] = []

    @property
    def transport_stats(self) -> dict:
        """Dense-channel + (when remote) PS-channel retry counters."""
        stats = {"dense": self._dense.stats.as_dict()}
        if self._kv is not None:
            stats["ps"] = self._kv.stats.as_dict()
        return stats

    # -- sparse tier ----------------------------------------------------
    def _pull(self, table: str, ids: np.ndarray, dim: int) -> np.ndarray:
        if self._kv is not None:
            return self._kv.pull(table, dim, ids, init_std=self.init_std)
        t = self._local.setdefault(
            table, LargeScaleKV(dim, init_std=self.init_std))
        return t.pull(ids)

    def _push(self, table: str, ids: np.ndarray, grads: np.ndarray,
              dim: int):
        if self._kv is not None:
            self._kv.push(table, dim, ids, grads, self.lr,
                          init_std=self.init_std)
        else:
            self._local[table].push(ids, grads.reshape(len(ids), dim),
                                    self.lr)

    # -- one async step -------------------------------------------------
    def train_one_batch(self, ids, dense, label) -> float:
        cfg = self.cfg
        ids = np.asarray(ids, np.int64)
        B, S = ids.shape
        uids, inv = np.unique(ids.ravel(), return_inverse=True)
        emb_rows = self._pull("embed", uids, cfg.embed_dim)   # [U, D]
        wide_rows = self._pull("wide", uids, 1)               # [U, 1]
        # host-side gather + flatten (the CPU side of the heter split)
        emb = emb_rows[inv].reshape(B, S * cfg.embed_dim)
        wide_sum = wide_rows[inv].reshape(B, S, 1).sum(axis=1)
        rep = self._dense.call({
            "op": "step", "emb": emb.astype(np.float32),
            "wide": wide_sum.astype(np.float32),
            "dense": np.asarray(dense, np.float32),
            "label": np.asarray(label, np.float32)})
        # scatter activation grads back to rows: d_row accumulates over
        # every (b, s) occurrence of the id
        d_emb = np.asarray(rep["d_emb"]).reshape(B * S, cfg.embed_dim)
        d_wide = np.repeat(np.asarray(rep["d_wide"]), S, axis=0)  # [B*S,1]
        g_emb = np.zeros_like(emb_rows)
        np.add.at(g_emb, inv, d_emb)
        g_wide = np.zeros_like(wide_rows)
        np.add.at(g_wide, inv, d_wide)
        self._push("embed", uids, g_emb, cfg.embed_dim)
        self._push("wide", uids, g_wide, 1)
        self.losses.append(rep["loss"])
        return rep["loss"]

    def dense_params(self) -> dict:
        return self._dense.call({"op": "params"})

    def stop_dense(self):
        try:
            self._dense.call({"op": "stop"}, deadline=10.0)
        except (ConnectionError, OSError):
            pass

    def close(self):
        self._dense.close()
        if self._kv is not None:
            self._kv.close()

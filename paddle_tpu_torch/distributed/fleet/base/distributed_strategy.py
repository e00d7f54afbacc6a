"""DistributedStrategy (counterpart of
``paddle_tpu/distributed/fleet/base/distributed_strategy.py``; reference
distributed/fleet/base/distributed_strategy.py:101).

The strategy bag with the reference's fields and defaults, serialisable
to a dict or JSON. In the port, data parallelism reads no field; the
meta-optimizer flags (amp, recompute, gradient_merge, lamb, lars,
localsgd, dgc) raise at ``fleet.minimize`` until their items land, and
the hybrid degrees go to ``fleet.hybrid_train_step``.
"""
from __future__ import annotations

import copy

__all__ = ["DistributedStrategy"]

_DEFAULTS = {
    # execution
    "auto": False,
    "a_sync": False,
    "a_sync_configs": {"k_steps": -1, "max_merge_var_num": 20,
                       "send_queue_size": 20,
                       "independent_recv_thread": False,
                       "thread_pool_size": 1, "send_wait_times": 1,
                       "runtime_split_send_recv": False, "launch_barrier": True,
                       "geo_sgd_mode": False, "geo_sgd_need_push_nums": 100},
    # amp
    "amp": False,
    "amp_configs": {"init_loss_scaling": 32768.0,
                    "incr_every_n_steps": 1000,
                    "decr_every_n_nan_or_inf": 2, "incr_ratio": 2.0,
                    "decr_ratio": 0.5, "use_dynamic_loss_scaling": True,
                    "custom_white_list": [], "custom_black_list": [],
                    "use_pure_bf16": True},
    # recompute
    "recompute": False,
    "recompute_configs": {"checkpoints": []},
    # pipeline
    "pipeline": False,
    "pipeline_configs": {"micro_batch": 1, "accumulate_steps": 1,
                         "schedule_mode": "1F1B"},
    # gradient merge
    "gradient_merge": False,
    "gradient_merge_configs": {"k_steps": 1, "avg": True},
    # optimizers
    "lamb": False,
    "lamb_configs": {"lamb_weight_decay": 0.01,
                     "exclude_from_weight_decay": []},
    "lars": False,
    "lars_configs": {"lars_coeff": 0.001, "lars_weight_decay": 0.0005,
                     "epsilon": 0.0, "exclude_from_weight_decay": []},
    "localsgd": False,
    "localsgd_configs": {"k_steps": 1, "begin_step": 1},
    "dgc": False,
    "dgc_configs": {"rampup_begin_step": 0, "rampup_step": 1,
                    "sparsity": [0.999]},
    # collective tuning (kept for parity; the port's gradient buckets
    # are DataParallel's comm_buffer_size)
    "fuse_all_reduce_ops": True,
    "fuse_grad_size_in_MB": 32,
    "nccl_comm_num": 1,
    "sync_nccl_allreduce": True,
    "use_hierarchical_allreduce": False,
    "hierarchical_allreduce_inter_nranks": 1,
    "sync_batch_norm": False,
    "fuse_grad_merge": False,
    "cudnn_exhaustive_search": False,
    "conv_workspace_size_limit": 512,
    "cudnn_batchnorm_spatial_persistent": False,
    # the JAX package's extensions (tensor / sequence / expert
    # parallelism); sharding_rules: [(param-name-regex,
    # partition-spec-tuple)], e.g. ("fc_.*\\.w_0", (None, "tp"))
    "tensor_parallel": False,
    "tensor_parallel_configs": {"tensor_parallel_degree": 1,
                                "sharding_rules": []},
    # hybrid dp x pp x tp for the functional engine
    # (parallel.HybridParallelTrainStep via fleet.hybrid_train_step)
    "hybrid_configs": {"dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
                       "sp_degree": 1, "micro_batches": None},
    "sharding": False,
    "sharding_configs": {"sharding_degree": 1, "stage": 1},
    "sequence_parallel": False,
    "sequence_parallel_configs": {"sp_degree": 1, "ring_attention": True},
    "expert_parallel": False,
    "expert_parallel_configs": {"ep_degree": 1},
}


class DistributedStrategy:
    def __init__(self):
        self.__dict__["_d"] = copy.deepcopy(_DEFAULTS)

    def __getattr__(self, k):
        d = self.__dict__["_d"]
        if k in d:
            return d[k]
        raise AttributeError(k)

    def __setattr__(self, k, v):
        d = self.__dict__["_d"]
        if k not in d:
            raise ValueError(f"unknown strategy field {k!r}")
        if k.endswith("_configs"):
            merged = dict(_DEFAULTS[k])
            merged.update(v)
            d[k] = merged
        else:
            d[k] = v

    def to_dict(self) -> dict:
        return copy.deepcopy(self.__dict__["_d"])

    @classmethod
    def from_dict(cls, d: dict) -> "DistributedStrategy":
        s = cls()
        s.__dict__["_d"].update(copy.deepcopy(d))
        return s

    def save_to_prototxt(self, path):
        import json
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    def load_from_prototxt(self, path):
        import json
        with open(path) as f:
            self.__dict__["_d"].update(json.load(f))

    def __repr__(self):
        on = [k for k, v in self.__dict__["_d"].items()
              if isinstance(v, bool) and v]
        return f"DistributedStrategy(enabled={on})"

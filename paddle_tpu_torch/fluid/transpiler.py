"""Distribute transpiler (counterpart of ``paddle_tpu/fluid/transpiler.py``):
the config bag the fleet 1.x StrategyFactory fills is here; rewriting a
program into trainer and pserver programs (``DistributeTranspiler``)
raises until ROADMAP.md A, item 12 ports it."""
from __future__ import annotations

__all__ = ["DistributeTranspilerConfig", "DistributeTranspiler"]


class DistributeTranspilerConfig:
    """Reference transpiler config bag (slice_var_up etc. — row-hash
    routing subsumes explicit var slicing)."""

    def __init__(self):
        self.slice_var_up = True
        self.split_method = None
        self.min_block_size = 8192
        self.sync_mode = False
        self.runtime_split_send_recv = False
        self.mode = "pserver"
        # GEO-SGD (reference GeoSgdTranspiler config)
        self.geo_sgd_mode = False
        self.geo_sgd_need_push_nums = 100


class DistributeTranspiler:
    def __init__(self, config: DistributeTranspilerConfig | None = None):
        raise NotImplementedError(
            "fluid.transpiler.DistributeTranspiler is not ported yet: it "
            "comes with ROADMAP.md A, item 12")

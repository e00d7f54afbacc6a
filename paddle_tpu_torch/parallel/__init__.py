"""Training over a device mesh: the hybrid GPT step (dp x pp x tp,
both pipeline schedules, ZeRO-1) and the pieces it is built from."""
from .hybrid import HybridParallelTrainStep, make_hybrid_mesh

__all__ = ["HybridParallelTrainStep", "make_hybrid_mesh"]

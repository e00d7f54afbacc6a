"""Training over a device mesh (so far: one device)."""
from .hybrid import HybridParallelTrainStep

__all__ = ["HybridParallelTrainStep"]

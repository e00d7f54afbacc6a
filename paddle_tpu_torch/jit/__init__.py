"""Whole-step training entry points (counterpart of ``paddle_tpu/jit``)."""
from .functional import TrainStep, make_train_step

__all__ = ["TrainStep", "make_train_step"]

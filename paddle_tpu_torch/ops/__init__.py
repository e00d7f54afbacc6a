"""Kernels of the port: hand-written CUDA for Hopper (``csrc/``), each
with its plain PyTorch version beside it. ``_build`` compiles the
sources with nvcc at first use and holds the launch counters."""
from ._build import launch_counts, reset_launch_counts

__all__ = ["launch_counts", "reset_launch_counts"]

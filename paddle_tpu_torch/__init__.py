"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The port runs on an NVIDIA Hopper card (sm_90a): plain tensor code is
PyTorch, and each Pallas kernel of the JAX package on a ported path is
a hand-written CUDA kernel under ``ops/csrc/``, built by nvcc at first
use. Importing the package needs neither nvcc nor a card; entry points
default to CUDA and raise without one unless given ``device="cpu"``,
where the kernels' plain PyTorch versions run.

Ported so far: the GPT serving path (``serving.Engine`` over
``serving.GPTDecodeModel``, ``models.gpt``) with its kernels
``ops.paged_attention`` and ``ops.fused_block``.
"""
__all__ = ["models", "ops", "serving", "observability"]

"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The port runs on an NVIDIA Hopper card (sm_90a): plain tensor code is
PyTorch, and each Pallas kernel of the JAX package on a ported path is
a hand-written CUDA kernel under ``ops/csrc/``, built by nvcc at first
use. Importing the package needs neither nvcc nor a card; entry points
default to CUDA and raise without one unless given ``device="cpu"``,
where the kernels' plain PyTorch versions run.

Ported so far: the GPT serving path (``serving.Engine`` over
``serving.GPTDecodeModel``, ``models.gpt``) with its kernels
``ops.paged_attention`` and ``ops.fused_block``; the GPT train step
(``parallel.HybridParallelTrainStep``) with ``ops.flash_attention``; and
the BERT pretrain step (``jit.make_train_step`` over
``models.bert.BertForPretraining``, built on ``nn`` and ``amp``) with
``ops.layer_norm``, ``ops.fused_residual`` and the dropout, padding
mask, pre/post-norm and gelu/relu variants of the earlier kernels; and
the static graph (``enable_static()``, then ``fluid.layers`` /
``common_ops.run_op`` into a ``fluid.Program``, ``fluid.optimizer.Adam``
whose ``minimize`` appends the backward and the updates, and
``fluid.Executor`` running it op by op) with the ops of
``models.lenet.build_lenet_program`` and the ``fused_ffn`` op over
``ops.fused_ffn``, the last of the JAX package's Pallas kernels.
"""
__all__ = ["amp", "common_ops", "fluid", "jit", "models", "nn", "ops",
           "parallel", "serving", "static", "observability",
           "enable_static", "disable_static", "in_dynamic_mode"]


def enable_static():
    """Build static Programs from here on (the reference's
    ``paddle.enable_static``)."""
    from .fluid import framework
    framework.disable_dygraph()


def disable_static(place=None):
    """Back to dygraph mode, the default."""
    from .fluid import framework
    framework.enable_dygraph()


def in_dynamic_mode() -> bool:
    from .fluid import framework
    return framework.in_dygraph_mode()

"""paddle_tpu_torch.serving — continuous-batching inference over a paged
KV cache, on a CUDA card (counterpart of ``paddle_tpu.serving``).

    from paddle_tpu_torch.models.gpt import GPTConfig
    from paddle_tpu_torch.serving import Engine, GPTDecodeModel

    model = GPTDecodeModel(GPTConfig.gpt3_1p3b())        # on the card
    eng = Engine(model, num_slots=8, num_pages=256, page_size=16)
    req = eng.submit([1, 2, 3], max_new_tokens=16)
    eng.run_until_idle()
    tokens = req.result()

``GPTDecodeModel(..., device="cpu")`` runs the plain PyTorch versions
of the kernels on the CPU (the tests do); without a card and without
that argument the model raises.
"""
from .kv_cache import PagePool, PageTable, defrag_plan, pages_needed
from .prefix_cache import PrefixCache, PrefixMatch
from .sampling import SamplingParams, derive_seed
from .scheduler import (QueueFull, QuotaExceeded, Request, Scheduler,
                        TokenBucket)
from .model import GPTDecodeModel
from .engine import Engine

__all__ = [
    "PagePool", "PageTable", "pages_needed", "defrag_plan",
    "PrefixCache", "PrefixMatch", "SamplingParams", "derive_seed",
    "Request", "Scheduler", "QueueFull", "QuotaExceeded", "TokenBucket",
    "GPTDecodeModel", "Engine",
]

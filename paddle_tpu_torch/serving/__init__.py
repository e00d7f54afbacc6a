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

Network mode (the multiplexed wire, see serving/frontend.py) and the
open-loop load generator (serving/loadgen.py):

    from paddle_tpu_torch.serving import (LoadGenerator, ServingClient,
                                          ServingServer, TrafficConfig,
                                          slo_report)
    srv = ServingServer(eng, "127.0.0.1:0").start()   # engine's thread
    cli = ServingClient(srv.endpoint)
    out = cli.generate([1, 2, 3], 16)                  # {"tokens": ...}
    res = LoadGenerator(TrafficConfig(rate=8, duration=6)).run_client(cli)
    print(slo_report(res))

The replicated fleet's router (``paddle_tpu.serving.router``) is not
ported yet: it waits for the telemetry plane (ROADMAP item 18).
"""
from .kv_cache import PagePool, PageTable, defrag_plan, pages_needed
from .prefix_cache import PrefixCache, PrefixMatch
from .sampling import SamplingParams, derive_seed
from .scheduler import (QueueFull, QuotaExceeded, Request, Scheduler,
                        TokenBucket)
from .model import GPTDecodeModel
from .engine import Engine
from .frontend import ServingClient, ServingServer
from .loadgen import (Arrival, LoadGenerator, LoadResult, TrafficConfig,
                      slo_report)

__all__ = [
    "PagePool", "PageTable", "pages_needed", "defrag_plan",
    "PrefixCache", "PrefixMatch", "SamplingParams", "derive_seed",
    "Request", "Scheduler", "QueueFull", "QuotaExceeded", "TokenBucket",
    "GPTDecodeModel", "Engine", "ServingServer", "ServingClient",
    "Arrival", "LoadGenerator", "LoadResult", "TrafficConfig",
    "slo_report",
]

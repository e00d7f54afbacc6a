"""paddle_tpu_torch.publish — the online-learning loop's publication tier
(counterpart of ``paddle_tpu.publish``).

Closes train→serve continuously (reference: the ads-scale
Communicator/BoxPS loop): exporters route PS tables and dense trainer
state through the content-addressed checkpoint store into numbered
version manifests, a durable registry tracks latest/pinned/rollback
pointers and streams version announces over the mux wire, and
subscribers hot-swap serving engines mid-traffic with the two-phase
read/adopt warm start (``Engine.warm_start``). Registry docs, manifests
and chunks are the JAX package's bytes: either package's subscriber
adopts a version the other published.
"""
from .exporter import PSExporter, Publisher, parity_digest
from .registry import (PUB_READ_OPS, RegistryClient, RegistryError,
                       RegistryServer, VersionRegistry,
                       registry_dispatch)
from .subscriber import VersionSubscriber

__all__ = [
    "Publisher", "PSExporter", "parity_digest",
    "VersionRegistry", "RegistryServer", "RegistryClient",
    "RegistryError", "registry_dispatch", "PUB_READ_OPS",
    "VersionSubscriber",
]

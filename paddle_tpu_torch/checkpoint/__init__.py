"""paddle_tpu_torch.checkpoint — crash-consistent checkpoint substrate
(the port's copy of ``paddle_tpu.checkpoint``, byte for byte the same
format, so either package restores what the other saved).

Content-addressed chunks + CRC'd JSON manifests committed by atomic
rename (store.py / chunks.py / manifest.py), async save that never
blocks the step, row-level WAL journaling (wal.py), and
resharding-aware restore. ``CheckpointStore.save`` takes numpy arrays
and ``torch.Tensor``s on any device (copied to the host); a bfloat16
array raises, as in the JAX package. Consumers in the port: the serving
model's ``save_checkpoint`` / ``from_checkpoint`` and the engine's
``warm_start`` / ``from_checkpoint``.

No pickle on any restore path (``scripts/check_no_wire_pickle.py
paddle_tpu_torch/checkpoint`` scans this tree).
"""
from .chunks import ChunkError, ChunkStore
from .manifest import (ManifestError, commit_manifest, list_manifests,
                       load_latest, load_manifest)
from .store import DEFAULT_CHUNK_BYTES, CheckpointStore, ShardedArray
from .wal import RowJournal, committed_length, replay_file

__all__ = [
    "CheckpointStore", "ShardedArray", "ChunkStore", "ChunkError",
    "RowJournal", "replay_file", "committed_length", "ManifestError",
    "commit_manifest", "load_manifest", "load_latest",
    "list_manifests", "DEFAULT_CHUNK_BYTES", "enabled",
]


def enabled() -> bool:
    """Is the store-format routing for fluid/hapi save paths on
    (``PADDLE_TPU_CKPT``)? Kept with the JAX package's meaning; the
    port's fluid save path that reads it comes with ROADMAP.md item
    12."""
    import os
    return os.environ.get("PADDLE_TPU_CKPT", "") not in ("", "0",
                                                         "false")

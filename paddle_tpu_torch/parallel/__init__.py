"""Training over a device mesh: the hybrid GPT step (dp x pp x tp x sp
x ep, both pipeline schedules, ZeRO-1), ring attention, the expert
layer, the row-sharded embedding and the pieces they are built from."""
from . import pipeline, sequence_parallel, sharding
from .embedding import ShardedEmbedding, sharded_embedding_lookup
from .hybrid import HybridParallelTrainStep, make_hybrid_mesh
from .sequence_parallel import ring_attention

__all__ = ["pipeline", "sharding", "sequence_parallel",
           "HybridParallelTrainStep", "make_hybrid_mesh",
           "ShardedEmbedding", "sharded_embedding_lookup", "ring_attention"]

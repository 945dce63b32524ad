"""Sequence/context + expert parallelism libraries (SPMD, mesh-native).

Port of parsec_tpu/parallel over torch.distributed: ring attention
(neighbour ppermute pipeline = the reference's chain topology), Ulysses
attention (all-to-all head<->sequence resharding = redistribute), MoE
over an expert axis, a GPipe pipeline, and the dispatching collectives,
whose runtime path runs as ptc_coll_* taskpools over a live multi-rank
Context (comm/coll.py).  Mesh functions run on every rank of a Mesh
(parallel/mesh.py) and take and return this rank's shard.
"""
from .mesh import MeshSpec, make_mesh
from .collectives import (ring_permute, seq_all_gather, seq_reduce_scatter,
                          seq_all_to_all, all_reduce, reduce_scatter,
                          all_gather, broadcast)
from .ring_attention import ring_attention, blockwise_attention_reference
from .ulysses import ulysses_attention
from .expert import moe_ffn, moe_ffn_reference
from .multihost import init_distributed, process_info

__all__ = [
    "init_distributed", "process_info",
    "MeshSpec", "make_mesh",
    "ring_permute", "seq_all_gather", "seq_reduce_scatter", "seq_all_to_all",
    "all_reduce", "reduce_scatter", "all_gather", "broadcast",
    "ring_attention", "blockwise_attention_reference", "ulysses_attention",
    "moe_ffn", "moe_ffn_reference",
]

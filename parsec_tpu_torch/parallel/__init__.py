"""Parallel libraries.

Port of parsec_tpu/parallel, so far its runtime front door only: the
dispatching collectives (`all_reduce`, `reduce_scatter`, `all_gather`,
`broadcast`) over a live multi-rank Context, run as runtime-native
ptc_coll_* taskpools (comm/coll.py).  The mesh libraries (the `mesh=`
path of the collectives, ring_permute and the seq_* helpers, expert,
mesh, multihost, pipeline, ring_attention, ulysses) need
torch.distributed and are not ported yet.
"""
from .collectives import all_gather, all_reduce, broadcast, reduce_scatter

__all__ = ["all_reduce", "reduce_scatter", "all_gather", "broadcast"]

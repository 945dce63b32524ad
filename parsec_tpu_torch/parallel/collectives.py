"""The dispatching collectives' runtime front door.

Port of the runtime half of parsec_tpu/parallel/collectives.py: with a
live multi-rank Context (`ctx=`), each op runs as a RUNTIME-NATIVE
ptc_coll_* taskpool (comm/coll.py — tile slices stream into the
reduction chunk-granularly, topology per the transfer-economics
selector); with `tp=` (a live taskpool the caller is about to run) the
reduction emits into that pool instead and the returned buffer fills as
the pool executes.  The reference's other two paths are not ported: the
`mesh=` path (whole-array collectives over a device mesh) needs
torch.distributed, and without a live multi-rank Context the reference
returns the local contribution.  Both raise NotImplementedError here.
"""
from typing import Optional

import numpy as np

__all__ = ["all_reduce", "reduce_scatter", "all_gather", "broadcast"]


def _runtime_live(ctx) -> bool:
    """A Context qualifies for the runtime-native ptc_coll_* path when
    it is live, multi-rank and its comm engine is up."""
    return (ctx is not None and getattr(ctx, "comm_enabled", False)
            and max(1, ctx.nodes) > 1)


def _runtime_only(op: str, ctx, mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            f"parallel.{op}(mesh=...): the mesh path needs "
            "torch.distributed and is not ported to parsec_tpu_torch yet")
    if not _runtime_live(ctx):
        raise NotImplementedError(
            f"parallel.{op} without a live multi-rank ctx (comm engine "
            "up, nodes > 1) is not ported to parsec_tpu_torch yet")


def all_reduce(x, ctx=None, mesh=None, axis: str = "sp", op: str = "sum",
               topo: Optional[str] = None, tp=None):
    """Elementwise-reduce per-rank contributions; replicated result.
    `x` is THIS rank's local contribution; returns the cross-rank
    reduction (same shape).  With `tp`, the chains emit into that live
    pool: the returned array is zero-filled now and written by the
    fan-out sinks as the pool runs."""
    _runtime_only("all_reduce", ctx, mesh)
    if tp is not None:
        from ..comm.coll import all_reduce_into
        return all_reduce_into(ctx, tp, np.asarray(x), op=op, topo=topo)
    from ..comm.coll import all_reduce as _ar
    return _ar(ctx, np.asarray(x), op=op, topo=topo)


def reduce_scatter(x, ctx=None, mesh=None, axis: str = "sp",
                   op: str = "sum", topo: Optional[str] = None, tp=None):
    """Reduce + scatter 1/R segments: returns THIS rank's flat segment of
    the reduction.  With `tp`, emits into that live pool and returns the
    deferred segment buffer (see all_reduce)."""
    _runtime_only("reduce_scatter", ctx, mesh)
    if tp is not None:
        from ..comm.coll import reduce_scatter_into
        return reduce_scatter_into(ctx, tp, np.asarray(x), op=op,
                                   topo=topo)
    from ..comm.coll import reduce_scatter as _rs
    return _rs(ctx, np.asarray(x), op=op, topo=topo)


def all_gather(x, ctx=None, mesh=None, axis: str = "sp",
               topo: Optional[str] = None):
    """Concatenate per-rank contributions (rank order) on every rank:
    returns the flat R*size concatenation."""
    _runtime_only("all_gather", ctx, mesh)
    from ..comm.coll import all_gather as _ag
    return _ag(ctx, np.asarray(x), topo=topo)


def broadcast(x, root: int = 0, ctx=None, mesh=None, axis: str = "sp",
              topo: Optional[str] = None):
    """Broadcast the root's contribution to every rank: every rank passes
    a same-shape `x`, the root's values win (returned on all ranks)."""
    _runtime_only("broadcast", ctx, mesh)
    from ..comm.coll import broadcast as _bc
    return _bc(ctx, np.asarray(x), root=root, topo=topo)

"""Sequence-sharding collectives and the dispatching front door.

Port of parsec_tpu/parallel/collectives.py.  The reference wraps each XLA
collective in a `shard_map`; this port is explicit SPMD code over
torch.distributed: every function here runs on each rank of a Mesh
(parallel/mesh.py) and takes and returns THIS rank's shard, as the body
of the reference's `shard_map` sees it.

Differentiable collectives.  `psum`, `pbroadcast`, `ppermute`,
`all_gather`, `psum_scatter` and `all_to_all` are torch.autograd
Functions whose backward is the collective JAX transposes them to:
  psum        all-reduce; backward identity (its result is the same on
              every rank, and so is the cotangent it receives)
  pbroadcast  identity; backward all-reduce (a value that is the same on
              every rank of `axis` feeding rank-varying work, as in a
              column-parallel product: the Megatron "f" operator)
  ppermute    moves each shard along a permutation; backward the inverse
              permutation
  all_gather  tiled all-gather; backward psum_scatter
  psum_scatter  reduce + scatter; backward all_gather
  all_to_all  split one dim over the ranks while gathering another;
              backward the reverse all_to_all
The graph a rank builds must be the same on every rank (shape and order
of the collectives; only values may depend on the rank), because each
backward collective waits for its partners: branch on the rank with
tensor masks, never with Python control flow around a collective.

Transport.  The collectives take the tensors where they lie.  NCCL takes
every op on the card.  gloo (two ranks on one card, or the CPU) runs
only the ops in `GLOO_CUDA_OPS` on CUDA tensors; the others (all_to_all,
which gloo lacks for the card, and ppermute's send/recv, which would
hand a card pointer to gloo's TCP transport) are staged through pinned
host memory in `_Xfer`, the one place that does so, and their bytes
are counted in `mesh.staged`.  The compute stays on the card.

The front door (`all_reduce`, `reduce_scatter`, `all_gather`,
`broadcast`) dispatches as the reference's: with a live multi-rank
Context (`ctx=`) the op runs as a RUNTIME-NATIVE ptc_coll_* taskpool
(comm/coll.py) and `x` is this rank's contribution; with `mesh=` `x`
stacks every rank's contribution on dim 0, rank r contributes
`x[r's index on axis]`, and every rank returns what the reference
returns; with neither, the local semantics (`x` is the only
contribution).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["ring_permute", "seq_all_gather", "seq_reduce_scatter",
           "seq_all_to_all", "all_reduce", "reduce_scatter", "all_gather",
           "broadcast", "psum", "pbroadcast", "ppermute", "psum_scatter",
           "all_to_all"]

# the ops gloo runs on CUDA tensors itself (`python3 chip_smoke.py
# --gloo-probe` on the card); the others are staged through host memory
GLOO_CUDA_OPS = frozenset({"all_reduce", "broadcast", "all_gather",
                           "reduce_scatter"})


# ------------------------------------------------------------- transport
class _Xfer:
    """The tensors one collective moves, on the device the op can take
    them: on the card, or pinned host copies of them (gloo with CUDA
    tensors for an op not in GLOO_CUDA_OPS), whose bytes are counted in
    `mesh.staged[op]` and copied back by `back`."""

    def __init__(self, mesh, axis: str, op: str):
        self.group = mesh.group(axis)
        self.mesh = mesh
        self.op = op
        self.staged = False

    def put(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        if t.is_cuda and self.op not in GLOO_CUDA_OPS and \
                dist.get_backend(self.group) == "gloo":
            self.staged = True
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t)
            self.mesh.count_staged(self.op, h.numel() * h.element_size())
            return h
        return t

    def empty(self, like: torch.Tensor) -> torch.Tensor:
        if self.staged:
            return torch.empty(like.shape, dtype=like.dtype,
                               pin_memory=True)
        return torch.empty_like(like)

    def back(self, t: torch.Tensor, device) -> torch.Tensor:
        if t.device == device:
            return t
        self.mesh.count_staged(self.op, t.numel() * t.element_size())
        return t.to(device)


def _all_reduce(x, mesh, axis):
    xf = _Xfer(mesh, axis, "all_reduce")
    y = xf.put(x)
    if y.data_ptr() == x.data_ptr():
        y = y.clone()
    dist.all_reduce(y, group=xf.group)
    return xf.back(y, x.device)


def _all_gather(x, mesh, axis, dim: int):
    n = mesh.shape[axis]
    xf = _Xfer(mesh, axis, "all_gather")
    h = xf.put(x)
    outs = [xf.empty(h) for _ in range(n)]
    dist.all_gather(outs, h, group=xf.group)
    return xf.back(torch.cat(outs, dim), x.device)


def _psum_scatter(x, mesh, axis, dim: int):
    n = mesh.shape[axis]
    if x.shape[dim] % n:
        raise ValueError(f"psum_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not divide over {axis!r} ({n})")
    xf = _Xfer(mesh, axis, "reduce_scatter")
    ins = [xf.put(c) for c in x.chunk(n, dim)]
    out = xf.empty(ins[0])
    dist.reduce_scatter(out, ins, group=xf.group)
    return xf.back(out, x.device)


def _all_to_all(x, mesh, axis, split_dim: int, concat_dim: int):
    n = mesh.shape[axis]
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of "
                         f"{tuple(x.shape)} does not divide over {axis!r} "
                         f"({n})")
    xf = _Xfer(mesh, axis, "all_to_all")
    # chunk j (for rank j) stacked on a new leading dim: the even split
    # of all_to_all_single, which gloo has where it lacks the list form
    h = xf.put(torch.stack(x.chunk(n, split_dim)))
    out = xf.empty(h)
    dist.all_to_all_single(out, h, group=xf.group)
    out = xf.back(out, x.device)
    return torch.cat(out.unbind(0), concat_dim)


def _ppermute(x, mesh, axis, perm: Sequence[Tuple[int, int]]):
    """Send this rank's x to every dst it is the src of; return what this
    rank receives (zeros when no src sends to it, as lax.ppermute)."""
    me = mesh.index(axis)
    xf = _Xfer(mesh, axis, "ppermute")
    h = xf.put(x)
    out = xf.empty(h).zero_()
    ops = []
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(h)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, h, mesh.rank_at(axis, dst),
                                  xf.group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out, mesh.rank_at(axis, src),
                                  xf.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return xf.back(out, x.device)


# ------------------------------------------------- autograd pairs
class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _PBroadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.axis), None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.inv = tuple((d, s) for s, d in perm)
        return _ppermute(x, mesh, axis, perm)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(g, ctx.mesh, ctx.axis, ctx.inv), None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _psum_scatter(g, ctx.mesh, ctx.axis, ctx.dim), None, None, \
            None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _psum_scatter(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None, \
            None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.dims = (split_dim, concat_dim)
        return _all_to_all(x, mesh, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return (_all_to_all(g, ctx.mesh, ctx.axis, concat_dim, split_dim),
                None, None, None, None)


def psum(x, mesh, axis: str):
    """Sum over `axis` (lax.psum); the same result on every rank."""
    return _Psum.apply(x, mesh, axis)


def pbroadcast(x, mesh, axis: str):
    """Identity whose backward sums the cotangent over `axis`."""
    return _PBroadcast.apply(x, mesh, axis)


def ppermute(x, mesh, axis: str, perm):
    """lax.ppermute: perm is a list of (src, dst) indices on `axis`."""
    return _PPermute.apply(x, mesh, axis, tuple(map(tuple, perm)))


def psum_scatter(x, mesh, axis: str, dim: int = 0):
    """lax.psum_scatter(..., tiled=True): sum over `axis`, keep this
    rank's 1/n slab of `dim`."""
    return _PsumScatter.apply(x, mesh, axis, dim)


def all_to_all(x, mesh, axis: str, split_dim: int, concat_dim: int):
    """lax.all_to_all(..., tiled=True)."""
    return _AllToAll.apply(x, mesh, axis, split_dim, concat_dim)


def _ring_perm(n: int, shift: int = 1):
    return [(i, (i + shift) % n) for i in range(n)]


# ------------------------------------------------ the reference's helpers
def ring_permute(x, mesh, axis: str, shift: int = 1, shard_dim: int = 0):
    """Rotate shards one step around the `axis` ring (chain topology:
    parsec/remote_dep.c:43 `remote_dep_bcast_chain_child`): rank i's
    shard moves to rank (i+shift) mod n.  `x` is this rank's shard (of a
    tensor sharded on `shard_dim`); returns the shard it receives."""
    return ppermute(x, mesh, axis, _ring_perm(mesh.shape[axis], shift))


def seq_all_gather(x, mesh, axis: str, shard_dim: int = 0):
    """Gather the sequence-sharded dim onto every rank: `x` is this
    rank's shard; returns the full tensor."""
    return _AllGather.apply(x, mesh, axis, shard_dim)


def seq_reduce_scatter(x, mesh, axis: str, shard_dim: int = 0):
    """Sum-reduce the ranks' `x` (each the full shape) and return this
    rank's shard along `shard_dim`."""
    return psum_scatter(x, mesh, axis, shard_dim)


def seq_all_to_all(x, mesh, axis: str, split_dim: int, concat_dim: int):
    """Reshard: split `split_dim` across `axis` while gathering the
    sharded `concat_dim` (the core move of Ulysses attention)."""
    return all_to_all(x, mesh, axis, split_dim, concat_dim)


# --------------------------------------------------------- front door
def _runtime_live(ctx) -> bool:
    """A Context qualifies for the runtime-native ptc_coll_* path when
    it is live, multi-rank and its comm engine is up."""
    return (ctx is not None and getattr(ctx, "comm_enabled", False)
            and max(1, ctx.nodes) > 1)


def _mine(x, mesh, axis: str) -> torch.Tensor:
    """This rank's contribution: row `index on axis` of `x`, which stacks
    every rank's on dim 0."""
    n = mesh.shape[axis]
    xs = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    if xs.dim() == 0 or xs.shape[0] != n:
        raise ValueError(
            f"mesh collective wants per-device contributions stacked on "
            f"dim 0 (length {n} for mesh axis {axis!r}); got shape "
            f"{tuple(xs.shape)}")
    return xs[mesh.index(axis)].to(mesh.device)


def all_reduce(x, ctx=None, mesh=None, axis: str = "sp", op: str = "sum",
               topo: Optional[str] = None, tp=None):
    """Elementwise-reduce per-rank contributions; replicated result.

    Runtime path (`ctx` live + multi-rank): `x` is THIS rank's local
    contribution; returns the cross-rank reduction (same shape).  With
    `tp` (a live taskpool the caller is about to run), the chains emit
    into that pool: the returned array is zero-filled now and written by
    the fan-out sinks as the pool runs.  Mesh path: `x` stacks the
    contributions on dim 0; returns their sum.  Neither: a copy of `x`."""
    if _runtime_live(ctx):
        if tp is not None:
            from ..comm.coll import all_reduce_into
            return all_reduce_into(ctx, tp, np.asarray(x), op=op,
                                   topo=topo)
        from ..comm.coll import all_reduce as _ar
        return _ar(ctx, np.asarray(x), op=op, topo=topo)
    if mesh is not None:
        if op != "sum":
            raise NotImplementedError("mesh all_reduce supports op='sum'")
        return _all_reduce(_mine(x, mesh, axis), mesh, axis)
    return np.asarray(x).copy()


def reduce_scatter(x, ctx=None, mesh=None, axis: str = "sp",
                   op: str = "sum", topo: Optional[str] = None, tp=None):
    """Reduce + scatter 1/R segments.

    Runtime path: `x` is this rank's contribution; returns THIS rank's
    flat segment of the reduction (with `tp`, the deferred segment
    buffer, see all_reduce).  Mesh path: `x` stacks the contributions on
    dim 0; each rank reduces and keeps its segment of the flat sum
    (zero-padded to divide), and returns every segment gathered, as the
    reference materializes them.  Neither: the local contribution,
    flat."""
    if _runtime_live(ctx):
        if tp is not None:
            from ..comm.coll import reduce_scatter_into
            return reduce_scatter_into(ctx, tp, np.asarray(x), op=op,
                                       topo=topo)
        from ..comm.coll import reduce_scatter as _rs
        return _rs(ctx, np.asarray(x), op=op, topo=topo)
    if mesh is not None:
        if op != "sum":
            raise NotImplementedError(
                "mesh reduce_scatter supports op='sum'")
        n = mesh.shape[axis]
        flat = _mine(x, mesh, axis).reshape(-1)
        flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % n))
        seg = _psum_scatter(flat, mesh, axis, 0)
        return _all_gather(seg, mesh, axis, 0)
    return np.ravel(np.asarray(x)).copy()


def all_gather(x, ctx=None, mesh=None, axis: str = "sp",
               topo: Optional[str] = None):
    """Concatenate per-rank contributions (rank order) on every rank.

    Runtime path: `x` is this rank's contribution; returns the flat
    R*size concatenation.  Mesh path: `x` stacks contributions on dim 0;
    returns their concatenation (flat).  Neither: the local
    contribution, flat."""
    if _runtime_live(ctx):
        from ..comm.coll import all_gather as _ag
        return _ag(ctx, np.asarray(x), topo=topo)
    if mesh is not None:
        return _all_gather(_mine(x, mesh, axis).reshape(-1), mesh, axis, 0)
    return np.ravel(np.asarray(x)).copy()


def broadcast(x, root: int = 0, ctx=None, mesh=None, axis: str = "sp",
              topo: Optional[str] = None):
    """Broadcast the root's contribution to every rank.

    Runtime path: every rank passes a same-shape `x`, the root's values
    win (returned on all ranks).  Mesh path: `x` stacks per-rank
    contributions on dim 0; returns contribution `root`, sent by the
    rank at index `root` on `axis`.  Neither: a copy of `x` (the caller
    IS the root)."""
    if _runtime_live(ctx):
        from ..comm.coll import broadcast as _bc
        return _bc(ctx, np.asarray(x), root=root, topo=topo)
    if mesh is not None:
        xf = _Xfer(mesh, axis, "broadcast")
        mine = _mine(x, mesh, axis)
        buf = xf.put(mine)
        if buf.data_ptr() == mine.data_ptr():
            buf = buf.clone()
        dist.broadcast(buf, mesh.rank_at(axis, root), group=xf.group)
        return xf.back(buf, mine.device)
    return np.asarray(x).copy()

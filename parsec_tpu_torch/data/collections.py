"""Distributed data collections: the tiled-matrix family and irregular
distributions.

Reference analogs:
  - parsec_data_collection_t vtable  (parsec/include/parsec/data_distribution.h:26-66)
  - 2D block-cyclic                  (parsec/data_dist/matrix/two_dim_rectangle_cyclic.c)
  - symmetric 2D block-cyclic       (parsec/data_dist/matrix/sym_two_dim_rectangle_cyclic.c)
  - band                            (parsec/data_dist/matrix/two_dim_rectangle_cyclic_band.c)
  - tabular (arbitrary tile->rank)  (parsec/data_dist/matrix/two_dim_tabular.c)
  - vector cyclic                   (parsec/data_dist/matrix/vector_two_dim_cyclic.c)
  - sub-tile view                   (parsec/data_dist/matrix/subtile.c)
  - hash datadist (irregular keys)  (parsec/data_dist/hash_datadist.c)

A collection supplies rank_of(*idx) (owner-computes placement) and
data_of(*idx) (the local datum).  Local tiles are numpy arrays; the CUDA
device layer mirrors them into device tensors on demand.  Port of
parsec_tpu/data/collections.py.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from .. import _native as N
from ..core.context import Context, Data


# serializes the lazy creation of tiles and their Data: workers that touch
# a tile first at the same time (data_of is called from the native core's
# workers) must share one array and one Data — one copy, one version, one
# device mirror — where check-then-set would give each its own
_LAZY = threading.RLock()


def _once(store: dict, key, make: Callable):
    """store[key], made by make() the first time, once across threads."""
    v = store.get(key)
    if v is None:
        with _LAZY:
            v = store.get(key)
            if v is None:
                v = store[key] = make()
    return v


class Collection:
    """Base: duck-typed vtable consumed by Context.register_collection."""

    nodes: int = 1
    myrank: int = 0

    def rank_of(self, *idx: int) -> int:
        raise NotImplementedError

    def data_of(self, *idx: int) -> Optional[Data]:
        raise NotImplementedError

    def register(self, ctx: Context, name: str) -> int:
        self._ctx = ctx
        return ctx.register_collection(name, self)

    def host_wrote(self) -> None:
        """Declare this collection's local host tiles rewritten outside
        the runtime: writes into `tile()` arrays, `fill`, `from_dense`,
        a copy into the tiles.  A copy's version moves only with the
        runtime's own writes, so without this a device may go on serving
        a mirror older than the new host bytes.  Every device mirror of
        a tile is dropped, and its owner stamp cleared, as when the
        runtime overwrites a host copy itself (each drop counts in that
        device's stats["invalidations"]); the next task that reads a
        tile stages the host bytes.  Call it once the writes are done
        and before the next taskpool reads the tiles.  Nothing to do
        before `register()`: no device can mirror the tiles yet."""
        ctx = getattr(self, "_ctx", None)
        if ctx is None:
            return
        with _LAZY:
            datas = list(self._local_datas())
        for d in datas:
            ctx._host_wrote_data(d)

    def _local_datas(self):
        """The Data made so far for this collection's local tiles (a
        tile's Data, so its host copy, exists once data_of made it)."""
        return getattr(self, "_datas", {}).values()

    # ---------------------------------------------- matrix-family helpers
    def stored(self, m: int, n: int) -> bool:
        """Whether tile (m, n) is physically stored."""
        return True

    def tile_shape(self, m: int, n: int) -> Tuple[int, int]:
        rows = min(self.mb, self.M - m * self.mb)
        cols = min(self.nb, self.N - n * self.nb)
        return rows, cols

    def fill(self, fn: Callable[[int, int], np.ndarray]):
        """Materialize every local stored tile via fn(m, n) -> array.  A
        write into host tiles: once a device has mirrored them, follow it
        with host_wrote()."""
        for m in range(self.mt):
            for n in range(self.nt):
                if self.stored(m, n) and self.rank_of(m, n) == self.myrank:
                    rows, cols = self.tile_shape(m, n)
                    self.tile(m, n)[:rows, :cols] = \
                        np.asarray(fn(m, n))[:rows, :cols]

    def to_dense(self) -> np.ndarray:
        """Gather stored tiles into a dense matrix (single-rank only)."""
        assert self.nodes == 1
        A = np.zeros((self.M, self.N), dtype=self.dtype)
        for m in range(self.mt):
            for n in range(self.nt):
                if not self.stored(m, n):
                    continue
                rows, cols = self.tile_shape(m, n)
                A[m * self.mb:m * self.mb + rows,
                  n * self.nb:n * self.nb + cols] = \
                    self.tile(m, n)[:rows, :cols]
        return A

    def from_dense(self, A: np.ndarray):
        """Copy a dense matrix into the local stored tiles.  A write into
        host tiles: once a device has mirrored them, follow it with
        host_wrote()."""
        for m in range(self.mt):
            for n in range(self.nt):
                if not self.stored(m, n):
                    continue
                if self.nodes > 1 and self.rank_of(m, n) != self.myrank:
                    continue
                rows, cols = self.tile_shape(m, n)
                self.tile(m, n)[:rows, :cols] = \
                    A[m * self.mb:m * self.mb + rows,
                      n * self.nb:n * self.nb + cols]


class _SymStorage:
    """Triangular-storage mixin shared by the sym variants: only one
    triangle's tiles exist (reference: sym_two_dim_rectangle_cyclic.c)."""

    def stored(self, m: int, n: int) -> bool:
        return n <= m if self.uplo == "lower" else m <= n

    def tile(self, m: int, n: int) -> np.ndarray:
        if not self.stored(m, n):
            raise KeyError(f"tile ({m},{n}) not stored ({self.uplo})")
        return super().tile(m, n)


class TwoDimBlockCyclic(Collection):
    """2D block-cyclic tiled matrix over a PxQ process grid.

    Tile (m, n) lives on rank (m % P) * Q + (n % Q); local tiles are
    allocated lazily as mb x nb numpy arrays.
    """

    def __init__(self, M: int, N: int, mb: int, nb: int, P: int = 1,
                 Q: int = 1, nodes: int = 1, myrank: int = 0,
                 dtype=np.float32, init: Optional[Callable] = None):
        assert P * Q == nodes, "grid P*Q must equal nodes"
        self.M, self.N, self.mb, self.nb = M, N, mb, nb
        self.P, self.Q = P, Q
        self.nodes, self.myrank = nodes, myrank
        self.mt = (M + mb - 1) // mb  # tiles in M
        self.nt = (N + nb - 1) // nb  # tiles in N
        self.dtype = np.dtype(dtype)
        self._tiles: Dict[Tuple[int, int], np.ndarray] = {}
        self._datas: Dict[Tuple[int, int], Data] = {}
        self._init = init

    def rank_of(self, m: int, n: int) -> int:
        return (m % self.P) * self.Q + (n % self.Q)

    def key_of(self, m: int, n: int) -> int:
        return m * self.nt + n

    def tile(self, m: int, n: int) -> np.ndarray:
        """The local tile array (allocating on first touch).  In
        single-rank mode a remote touch is a bug.  It is the host copy
        the runtime reads: a write into it once a device has mirrored it
        must be declared with host_wrote()."""
        key = (m, n)
        t = self._tiles.get(key)
        if t is not None:
            return t
        local = self.rank_of(m, n) == self.myrank
        if not local and self.nodes == 1:
            raise KeyError(f"tile {key} is remote (rank {self.rank_of(m, n)})")

        def make():
            # full mb x nb allocation (simplifies device staging); logical
            # shape may be smaller on boundary tiles
            t = np.zeros((self.mb, self.nb), dtype=self.dtype)
            if local and self._init is not None:
                rows, cols = self.tile_shape(m, n)
                t[:rows, :cols] = self._init(self, m, n)[:rows, :cols]
            return t

        return _once(self._tiles, key, make)

    def data_of(self, m: int, n: int) -> Optional[Data]:
        return _once(self._datas, (m, n), lambda: self._ctx.data(
            self.key_of(m, n), self.tile(m, n)))


class ReplicatedLocal(TwoDimBlockCyclic):
    """Rank-replicated tiled matrix: every rank holds (and owns) its own
    private instance of every tile.  rank_of always answers the local
    rank, so in a multi-rank context tasks touching the collection see
    purely local Mem edges on whichever rank they were anchored to: the
    placement of SPMD-replicated shard state (per-rank KV page pools,
    slot collections) in tensor-parallel serving, where the only
    cross-rank traffic is the explicit ptc_coll_* reduction wire.
    """

    def __init__(self, M: int, N: int, mb: int, nb: int, nodes: int = 1,
                 myrank: int = 0, dtype=np.float32,
                 init: Optional[Callable] = None):
        # storage is per-rank private: build the tile store single-rank,
        # then stamp the real (nodes, myrank) identity rank_of answers
        super().__init__(M, N, mb, nb, dtype=dtype, init=init)
        self.nodes, self.myrank = nodes, myrank

    def rank_of(self, m: int, n: int) -> int:
        return self.myrank


class SymTwoDimBlockCyclic(_SymStorage, TwoDimBlockCyclic):
    """Symmetric/lower(upper)-storage variant: only one triangle's tiles
    are stored and addressed — tasks only reference stored tiles.
    Placement cycles over the triangle like the reference's sym 2D BC
    (sym_two_dim_rectangle_cyclic.c)."""

    def __init__(self, *args, uplo: str = "lower", **kw):
        super().__init__(*args, **kw)
        self.uplo = uplo


class TwoDimBlockCyclicBand(Collection):
    """Band distribution: tiles within the band (|m - n| < band_size) live in
    a dedicated block-cyclic descriptor distributed along the band; off-band
    tiles use a regular 2D block-cyclic.  Reference:
    parsec/data_dist/matrix/two_dim_rectangle_cyclic_band.{h,c} — the
    composite dispatches rank_of/data_of on band membership.
    """

    def __init__(self, M: int, N: int, mb: int, nb: int, band_size: int = 1,
                 P: int = 1, Q: int = 1, nodes: int = 1, myrank: int = 0,
                 dtype=np.float32):
        self.band_size = band_size
        # band tiles distributed 1D-cyclically along the band over all
        # nodes (reference band desc: P = nodes, Q = 1)
        self.band = TwoDimBlockCyclic(M, N, mb, nb, P=1, Q=1, nodes=1,
                                      myrank=0, dtype=dtype)
        self.off_band = TwoDimBlockCyclic(M, N, mb, nb, P=P, Q=Q,
                                          nodes=nodes, myrank=myrank,
                                          dtype=dtype)
        self.M, self.N, self.mb, self.nb = M, N, mb, nb
        self.mt, self.nt = self.off_band.mt, self.off_band.nt
        self.nodes, self.myrank = nodes, myrank
        self.dtype = np.dtype(dtype)

    def in_band(self, m: int, n: int) -> bool:
        return abs(m - n) < self.band_size

    def rank_of(self, m: int, n: int) -> int:
        if self.in_band(m, n):
            # cyclic along the band diagonal
            return min(m, n) % self.nodes
        return self.off_band.rank_of(m, n)

    def tile(self, m: int, n: int) -> np.ndarray:
        part = self.band if self.in_band(m, n) else self.off_band
        return part.tile(m, n)

    def data_of(self, m: int, n: int) -> Optional[Data]:
        part = self.band if self.in_band(m, n) else self.off_band
        part._ctx = self._ctx
        return part.data_of(m, n)

    def _local_datas(self):
        return [*self.band._local_datas(), *self.off_band._local_datas()]


class SymTwoDimBlockCyclicBand(_SymStorage, TwoDimBlockCyclicBand):
    """Symmetric band variant (reference:
    sym_two_dim_rectangle_cyclic_band.{h,c}): only one triangle is stored;
    band dispatch as in TwoDimBlockCyclicBand."""

    def __init__(self, *args, uplo: str = "lower", **kw):
        super().__init__(*args, **kw)
        self.uplo = uplo


class TwoDimTabular(Collection):
    """Arbitrary tile→rank table (reference: two_dim_tabular.c)."""

    def __init__(self, M: int, N: int, mb: int, nb: int,
                 table: np.ndarray, nodes: int = 1, myrank: int = 0,
                 dtype=np.float32):
        self.M, self.N, self.mb, self.nb = M, N, mb, nb
        self.mt = (M + mb - 1) // mb
        self.nt = (N + nb - 1) // nb
        self.table = np.asarray(table, dtype=np.int64).reshape(self.mt, self.nt)
        self.nodes, self.myrank = nodes, myrank
        self.dtype = np.dtype(dtype)
        self._tiles: Dict[Tuple[int, int], np.ndarray] = {}
        self._datas: Dict[Tuple[int, int], Data] = {}

    def rank_of(self, m: int, n: int) -> int:
        return int(self.table[m, n])

    def tile(self, m: int, n: int) -> np.ndarray:
        return _once(self._tiles, (m, n), lambda: np.zeros(
            (self.mb, self.nb), dtype=self.dtype))

    def data_of(self, m: int, n: int) -> Optional[Data]:
        return _once(self._datas, (m, n), lambda: self._ctx.data(
            m * self.nt + n, self.tile(m, n)))


class VectorCyclic(Collection):
    """1-D cyclic distribution of vector segments (reference:
    vector_two_dim_cyclic.c)."""

    def __init__(self, N: int, nb: int, nodes: int = 1, myrank: int = 0,
                 dtype=np.float32):
        self.N, self.nb = N, nb
        self.nt = (N + nb - 1) // nb
        self.nodes, self.myrank = nodes, myrank
        self.dtype = np.dtype(dtype)
        self._segs: Dict[int, np.ndarray] = {}
        self._datas: Dict[int, Data] = {}

    def rank_of(self, k: int) -> int:
        return k % self.nodes

    def seg(self, k: int) -> np.ndarray:
        return _once(self._segs, k, lambda: np.zeros(self.nb,
                                                     dtype=self.dtype))

    def data_of(self, k: int) -> Optional[Data]:
        return _once(self._datas, k, lambda: self._ctx.data(k, self.seg(k)))


class SubtileView(TwoDimBlockCyclic):
    """Sub-tiled view of ONE tile, for recursive algorithms (reference:
    parsec/data_dist/matrix/subtile.c — a descriptor over a single tile of
    a parent collection, consumed by parsec_recursivecall).

    The parent tile's contents are copied into sub-tiles on construction;
    `writeback()` copies the (factored) sub-tiles back into the parent
    tile.  Always single-rank: recursive pools run where the parent task
    ran.
    """

    def __init__(self, parent_tile: np.ndarray, mb: int, nb: int):
        M, N = parent_tile.shape
        super().__init__(M, N, mb, nb, dtype=parent_tile.dtype)
        self._parent = parent_tile
        self.from_dense(parent_tile)

    def writeback(self):
        """Copy the sub-tiles back into the parent tile.  An inner pool
        whose chores ran on a CudaDevice left its results as dirty device
        mirrors, newer than the sub-tiles' host arrays: each is pulled to
        its host array first (the per-copy coherence pull, on the calling
        thread and without the writeback lane's barrier, so it is safe in
        the inner pool's completion callback, which the device's manager
        thread may run)."""
        from ..device.cuda import sync_copy_handle
        for d in list(self._datas.values()):
            h = N.lib.ptc_copy_handle(N.lib.ptc_data_host_copy(d._ptr))
            if h:
                sync_copy_handle(h)
        self._parent[...] = self.to_dense()


class HashDatadist(Collection):
    """Irregular user-keyed distribution (reference: hash_datadist.c):
    register arbitrary (key → rank, array) pairs."""

    def __init__(self, nodes: int = 1, myrank: int = 0):
        self.nodes, self.myrank = nodes, myrank
        self._ranks: Dict[int, int] = {}
        self._arrays: Dict[int, np.ndarray] = {}
        self._datas: Dict[int, Data] = {}

    def add(self, key: int, rank: int, array: Optional[np.ndarray] = None):
        self._ranks[key] = rank
        if array is not None:
            self._arrays[key] = array

    def rank_of(self, key: int) -> int:
        return self._ranks.get(key, 0)

    def data_of(self, key: int) -> Optional[Data]:
        arr = self._arrays.get(key)
        if arr is None:
            return None
        return _once(self._datas, key, lambda: self._ctx.data(key, arr))

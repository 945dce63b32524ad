"""Distributed data collections: the tiled-matrix family.

Reference analogs:
  - parsec_data_collection_t vtable  (parsec/include/parsec/data_distribution.h:26-66)
  - 2D block-cyclic                  (parsec/data_dist/matrix/two_dim_rectangle_cyclic.c)
  - vector cyclic                   (parsec/data_dist/matrix/vector_two_dim_cyclic.c)

A collection supplies rank_of(*idx) (owner-computes placement) and
data_of(*idx) (the local datum).  Local tiles are numpy arrays; the CUDA
device layer mirrors them into device tensors on demand.  Port of the
TwoDimBlockCyclic and VectorCyclic parts of
parsec_tpu/data/collections.py; the other distributions come with the
slices that use them.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np

from ..core.context import Context, Data


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

    # ---------------------------------------------- matrix-family helpers
    def stored(self, m: int, n: int) -> bool:
        """Whether tile (m, n) is physically stored."""
        return True

    def tile_shape(self, m: int, n: int) -> Tuple[int, int]:
        rows = min(self.mb, self.M - m * self.mb)
        cols = min(self.nb, self.N - n * self.nb)
        return rows, cols

    def fill(self, fn: Callable[[int, int], np.ndarray]):
        """Materialize every local stored tile via fn(m, n) -> array."""
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
        single-rank mode a remote touch is a bug."""
        key = (m, n)
        t = self._tiles.get(key)
        if t is None:
            local = self.rank_of(m, n) == self.myrank
            if not local and self.nodes == 1:
                raise KeyError(f"tile {key} is remote (rank {self.rank_of(m, n)})")
            # full mb x nb allocation (simplifies device staging); logical
            # shape may be smaller on boundary tiles
            t = np.zeros((self.mb, self.nb), dtype=self.dtype)
            if local and self._init is not None:
                rows, cols = self.tile_shape(m, n)
                t[:rows, :cols] = self._init(self, m, n)[:rows, :cols]
            self._tiles[key] = t
        return t

    def data_of(self, m: int, n: int) -> Optional[Data]:
        key = (m, n)
        d = self._datas.get(key)
        if d is None:
            d = self._ctx.data(self.key_of(m, n), self.tile(m, n))
            self._datas[key] = d
        return d


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
        if k not in self._segs:
            self._segs[k] = np.zeros(self.nb, dtype=self.dtype)
        return self._segs[k]

    def data_of(self, k: int) -> Optional[Data]:
        if k not in self._datas:
            self._datas[k] = self._ctx.data(k, self.seg(k))
        return self._datas[k]

"""Paged KV-cache attention as PTG taskpools (the Ragged Paged
Attention decode shape, arXiv:2604.15464).

Port of parsec_tpu/ops/paged_attention.py.  A sequence's KV cache lives
in fixed-size PAGES — (page, d) tiles of two ordinary tiled collections
— so the cache of many concurrent sequences shares one pool of runtime
tiles, staged to the card by the device module like any other tile.
Decode is blockwise over pages with the online-softmax recurrence
carried task-to-task:

  PUPD(s)      appends the step's new k/v row into the sequence's last
               page (in place + runtime dataflow to the attention task)
  PATTF(s, j)  folds FROZEN (full) page j into the (acc, m, l)
               accumulator — a per-sequence chain, pages ragged per
               sequence (pure-call lookup tables)
  PATTL(s)     folds the last (partial) page — received from PUPD
               through the DAG, never stale — normalizes, writes O

The prefill variant (build_paged_prefill) writes whole prompt pages
(PFILL) and runs the same fold chain for the last prompt position; the
verify variant (build_paged_verify) is the speculative-decoding wave.

Bit-exactness contract: every HOST fold uses `attend_page` below in f32
with a fixed operation order (copied unchanged from the reference), so
a batched decode step and a sequential per-request run produce
IDENTICAL bytes.  With a device attached, PATTF/VATF run `fold_heads`,
the torch form of the same fold on lane stacks; it agrees with the host
fold to f32 rounding (TF32 must stay off).

Not ported yet: tensor-parallel sharding (`shard=`, nodes > 1), which
needs the comm engine; asking for it raises NotImplementedError.
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import G, In, L, Mem, Out, Ref, call
from ..data.collections import TwoDimBlockCyclic

__all__ = ["PagePool", "SeqSpec", "attend_page", "attend_heads",
           "finalize_attention", "finalize_heads", "fold_heads",
           "build_paged_decode", "build_paged_prefill",
           "build_paged_verify", "make_slot_collections",
           "prefix_page_keys", "reset_acc"]


def _no_shard(nodes: int = 1, shard=None):
    if nodes > 1 or shard is not None:
        raise NotImplementedError(
            "tensor-parallel paged attention (nodes > 1, shard=) needs "
            "the comm engine, which is not ported to parsec_tpu_torch yet")


def prefix_page_keys(model_id: str, tokens: Sequence[int],
                     page: int) -> List[str]:
    """Content-hash keys for a prompt's FULL pages.  Key j digests
    (model id, tokens[0 : (j+1)*page]) — prefix-CUMULATIVE, so a page's
    KV bytes are a pure function of its key: a hit can only map onto a
    page holding exactly the bytes a cold prefill would write, and two
    processes computing the chain independently agree bit-for-bit."""
    h = hashlib.sha1(str(model_id).encode())
    keys: List[str] = []
    for j in range(len(tokens) // page):
        h.update(np.asarray(tokens[j * page:(j + 1) * page],
                            np.int64).tobytes())
        keys.append(h.hexdigest())
    return keys


# ------------------------------------------------------------ page pool
class PagePool:
    """Refcounted copy-on-write KV page pool: two tiled collections
    (K pages, V pages) of (page, d) tiles plus a free-list allocator.
    Pages are ordinary collection tiles — the device module stages them
    like any other tile, and `bytes_per_page` feeds admission budgets.

      refcounts     every live page carries a reference count; a page
                    is handed out again only at refcount 0 (a shared
                    frozen page can NEVER be evicted under a sharer)
      frozen index  FULL immutable pages register a content-hash key
                    — `freeze()`; `acquire_prefix()` maps the longest
                    page-aligned warm prefix of a new prompt onto
                    existing frozen pages (refcount++) so only the cold
                    tail prefills
      cached free   a frozen page released to refcount 0 keeps its
                    content and index entry on an LRU list; allocation
                    prefers never-written free pages and only then
                    evicts cached pages, counting `evictions`
      copy-on-write `make_private()` gives a writer an exclusive page:
                    the same page with its index entry dropped when
                    nobody shares it, else a fresh page with the bytes
                    copied (`cow_copies`) — a sharer's view is never
                    mutated

    Every operation is ATOMIC under the pool lock: admission's
    check-and-reserve (`reserve`/`acquire_prefix`) cannot interleave
    with concurrent sequence retirement."""

    def __init__(self, ctx, n_pages: int, page: int, d: int,
                 dtype=np.float32, name: str = "KV", nodes: int = 1,
                 myrank: int = 0):
        _no_shard(nodes)
        self.n_pages, self.page, self.d = n_pages, page, d
        self.dtype = np.dtype(dtype)
        self.name = name
        self._ctx = ctx
        self.Kc = TwoDimBlockCyclic(n_pages * page, d, page, d, dtype=dtype)
        self.Vc = TwoDimBlockCyclic(n_pages * page, d, page, d, dtype=dtype)
        self.k_name, self.v_name = f"{name}_K", f"{name}_V"
        self.Kc.register(ctx, self.k_name)
        self.Vc.register(ctx, self.v_name)
        self._lock = threading.Lock()
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        self._refs: List[int] = [0] * n_pages
        self._index: Dict[object, int] = {}      # content key -> page
        self._key_of: Dict[int, object] = {}     # page -> content key
        self._cached: "OrderedDict[int, bool]" = OrderedDict()  # LRU
        # frozen pages carry the tenant that wrote them (stats()
        # "cached_by_owner"; the reference's controller also steers
        # eviction by owner, which waits for the controller's port)
        self._owner_of: Dict[int, str] = {}      # page -> tenant tag
        self._counters = {
            "prefix_hits": 0, "prefix_misses": 0, "shared_bytes": 0,
            "cow_copies": 0, "evictions": 0, "reserve_fails": 0,
            "frozen": 0,
            # page migration (export_frozen / import_frozen)
            "exported": 0, "imported": 0, "import_dups": 0,
            "migrated_in_bytes": 0,
        }

    @property
    def free_pages(self) -> int:
        """Pages allocatable right now (never-written free list + the
        refcount-0 cached frozen pages an allocation may evict)."""
        with self._lock:
            return len(self._free) + len(self._cached)

    @property
    def bytes_per_page(self) -> int:
        return 2 * self.page * self.d * self.dtype.itemsize

    # ------------------------------------------------------- allocation
    def _take_free_locked(self) -> Optional[int]:
        if self._free:
            return self._free.pop()
        if self._cached:  # evict the LRU cached frozen page (refcount 0)
            p = next(iter(self._cached))
            del self._cached[p]
            key = self._key_of.pop(p)
            del self._index[key]
            self._owner_of.pop(p, None)
            self._counters["evictions"] += 1
            return p
        return None

    def alloc(self) -> Optional[int]:
        """One page at refcount 1, or None (backpressure signal)."""
        got = self.reserve(1)
        return got[0] if got else None

    def reserve(self, n: int) -> Optional[List[int]]:
        """ATOMIC check-and-reserve of `n` pages (each refcount 1) —
        all or nothing: on shortfall every page taken so far goes back
        and None returns (the admission backpressure signal)."""
        with self._lock:
            got: List[int] = []
            for _ in range(int(n)):
                p = self._take_free_locked()
                if p is None:
                    for q in got:
                        self._refs[q] = 0
                        self._free.append(q)
                    self._counters["reserve_fails"] += 1
                    return None
                self._refs[p] = 1
                got.append(p)
            return got

    def free(self, pages: Sequence[int]):
        """Release one reference per page (see `release`)."""
        self.release(pages)

    def release(self, pages: Sequence[int]):
        """Drop one reference per page.  At refcount 0 a frozen
        (content-indexed) page parks on the cached-free LRU — content
        preserved for future prefix hits — and an unindexed page goes
        straight back to the free list."""
        with self._lock:
            for p in pages:
                p = int(p)
                if self._refs[p] <= 0:
                    raise RuntimeError(f"page {p} over-released")
                self._refs[p] -= 1
                if self._refs[p] == 0:
                    if p in self._key_of:
                        self._cached[p] = True  # LRU tail (most recent)
                    else:
                        self._free.append(p)

    def retain(self, pages: Sequence[int]):
        """One extra reference per (already-live) page."""
        with self._lock:
            for p in pages:
                if self._refs[int(p)] <= 0:
                    raise RuntimeError(f"page {int(p)} is not live")
                self._refs[int(p)] += 1

    def refcount(self, p: int) -> int:
        with self._lock:
            return self._refs[int(p)]

    # ---------------------------------------------------- prefix sharing
    def freeze(self, p: int, key, owner: Optional[str] = None) -> bool:
        """Register a FULL immutable page under its content key.  First
        writer wins: a concurrent identical prefill keeps its private
        copy unindexed (False).  `owner` tags the page with the tenant
        that wrote it for share-aware eviction."""
        with self._lock:
            if key in self._index or int(p) in self._key_of:
                return False
            self._index[key] = int(p)
            self._key_of[int(p)] = key
            if owner is not None:
                self._owner_of[int(p)] = str(owner)
            self._counters["frozen"] += 1
            return True

    def is_frozen(self, p: int) -> bool:
        with self._lock:
            return int(p) in self._key_of

    def probe(self, keys: Sequence) -> int:
        """Longest warm prefix (leading keys present in the index) —
        NO side effects; admission's predicted-shared-page discount."""
        with self._lock:
            n = 0
            for k in keys:
                if k not in self._index:
                    break
                n += 1
            return n

    def acquire_prefix(self, keys: Sequence,
                       n_pages: int) -> Optional[Tuple[List[int], int]]:
        """ATOMIC admission of an `n_pages` sequence whose leading full
        pages carry content `keys`: map the longest warm prefix onto
        existing frozen pages (refcount++) and reserve fresh pages for
        the cold tail.  Returns (pages, warm_count), or None with every
        side effect rolled back when the cold tail doesn't fit."""
        with self._lock:
            warm: List[int] = []
            for k in keys:
                p = self._index.get(k)
                if p is None:
                    break
                warm.append(p)
            for p in warm:
                if self._refs[p] == 0:
                    self._cached.pop(p, None)
                self._refs[p] += 1
            cold: List[int] = []
            for _ in range(n_pages - len(warm)):
                p = self._take_free_locked()
                if p is None:
                    for q in cold:
                        self._refs[q] = 0
                        self._free.append(q)
                    for q in warm:
                        self._refs[q] -= 1
                        if self._refs[q] == 0:
                            self._cached[q] = True
                    self._counters["reserve_fails"] += 1
                    return None
                self._refs[p] = 1
                cold.append(p)
            self._counters["prefix_hits"] += len(warm)
            self._counters["prefix_misses"] += len(cold)
            self._counters["shared_bytes"] += \
                len(warm) * self.bytes_per_page
            return warm + cold, len(warm)

    def make_private(self, p: int) -> Optional[int]:
        """Exclusive writable view of page `p` for its (sole calling)
        owner: when nobody else holds it, the page itself with its
        index entry dropped; otherwise a COPY-ON-WRITE clone — fresh
        page, bytes copied, caller's reference moved (old refcount--).
        Returns None when the pool can't supply the clone."""
        with self._lock:
            p = int(p)
            if self._refs[p] <= 0:
                raise RuntimeError(f"page {p} is not live")
            if self._refs[p] == 1:
                key = self._key_of.pop(p, None)
                if key is not None:
                    del self._index[key]
                    self._owner_of.pop(p, None)
                return p
            q = self._take_free_locked()
            if q is None:
                self._counters["reserve_fails"] += 1
                return None
            self._refs[q] = 1
            self._refs[p] -= 1  # >0: sharers remain, p stays frozen
            self._counters["cow_copies"] += 1
        # bytes copied OUTSIDE the lock: q is exclusively ours, p is
        # immutable (frozen) while its sharers hold it
        np.copyto(self.k_tile(q), self.k_tile(p))
        np.copyto(self.v_tile(q), self.v_tile(p))
        self.host_wrote(q)
        return q

    def host_wrote(self, p: int):
        """The caller rewrote page `p`'s HOST bytes directly (numpy,
        outside the runtime): any device mirror is stale and must drop
        (COW clones, speculative row staging)."""
        self._ctx.host_wrote(self.Kc, int(p))
        self._ctx.host_wrote(self.Vc, int(p))

    # ------------------------------------------------- page migration
    def frozen_keys(self) -> List:
        """Snapshot of every content key currently indexed (live frozen
        pages AND cached-free ones)."""
        with self._lock:
            return list(self._index.keys())

    def export_frozen(self, key) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Copy a frozen page's (K, V) tiles out by content key, or None
        when the key is not indexed.  The page is PINNED (refcount++)
        for the out-of-lock copy, so a concurrent eviction can never
        recycle it mid-read; the pin is dropped afterwards."""
        with self._lock:
            p = self._index.get(key)
            if p is None:
                return None
            if self._refs[p] == 0:
                self._cached.pop(p, None)
            self._refs[p] += 1
            self._counters["exported"] += 1
        k = np.array(self.k_tile(p), copy=True)
        v = np.array(self.v_tile(p), copy=True)
        self.release([p])
        return k, v

    def import_frozen(self, key, k: np.ndarray, v: np.ndarray) -> bool:
        """Install a migrated frozen page under its content key.  True =
        page written and indexed (parked refcount-0 on the cached LRU);
        False = the key was already held (or won a concurrent race to
        the index) — ZERO page bytes written, `import_dups` counted."""
        with self._lock:
            if key in self._index:
                self._counters["import_dups"] += 1
                return False
            p = self._take_free_locked()
            if p is None:
                self._counters["reserve_fails"] += 1
                return False
            self._refs[p] = 1  # private until frozen: invisible to probes
        np.copyto(self.k_tile(p), np.asarray(k, dtype=self.dtype))
        np.copyto(self.v_tile(p), np.asarray(v, dtype=self.dtype))
        self.host_wrote(p)
        if not self.freeze(p, key):
            # lost a first-writer race since the check above: the winner
            # holds identical bytes, ours goes straight back (unindexed)
            self.release([p])
            with self._lock:
                self._counters["import_dups"] += 1
            return False
        with self._lock:
            self._counters["imported"] += 1
            self._counters["migrated_in_bytes"] += self.bytes_per_page
        self.release([p])  # refcount 0 + indexed -> cached-free LRU
        return True

    # ------------------------------------------------------------- stats
    def stats(self) -> dict:
        """Prefix-cache counter snapshot (stats()["serve"]["prefix"])."""
        with self._lock:
            out = dict(self._counters)
            out["n_pages"] = self.n_pages
            out["free"] = len(self._free)
            out["cached_free"] = len(self._cached)
            out["frozen_live"] = len(self._key_of)
            out["shared_refs"] = sum(
                r - 1 for p, r in enumerate(self._refs)
                if r > 1 and p in self._key_of)
            by_owner: Dict[str, int] = {}
            for q in self._cached:
                o = self._owner_of.get(q, "")
                by_owner[o] = by_owner.get(o, 0) + 1
            out["cached_by_owner"] = by_owner
            hits, misses = out["prefix_hits"], out["prefix_misses"]
            out["hit_rate"] = (hits / (hits + misses)
                               if hits + misses else 0.0)
            return out

    def k_tile(self, p: int) -> np.ndarray:
        return self.Kc.tile(p, 0)

    def v_tile(self, p: int) -> np.ndarray:
        return self.Vc.tile(p, 0)


def make_slot_collections(ctx, max_seqs: int, d: int, name: str = "PA",
                          nh: int = 1, nodes: int = 1, myrank: int = 0):
    """Per-slot scratch collections for `max_seqs` concurrent sequences:
    Qc (1, d) query rows, ACCc (1, d+2*nh) online-softmax accumulators
    ([acc | m_0..m_{nh-1} | l_0..l_{nh-1}]), Oc (1, d) attention
    outputs, KNc (1, 2d) the new token's k|v rows.  Registered as
    {name}_{Q,ACC,O,KN}.  `nh` is the number of attention heads (each
    with its own softmax state)."""
    _no_shard(nodes)
    aw = d + 2 * nh
    Qc = TwoDimBlockCyclic(max_seqs, d, 1, d, dtype=np.float32)
    ACCc = TwoDimBlockCyclic(max_seqs, aw, 1, aw, dtype=np.float32)
    Oc = TwoDimBlockCyclic(max_seqs, d, 1, d, dtype=np.float32)
    KNc = TwoDimBlockCyclic(max_seqs, 2 * d, 1, 2 * d, dtype=np.float32)
    names = {}
    for suffix, coll in (("Q", Qc), ("ACC", ACCc), ("O", Oc), ("KN", KNc)):
        n = f"{name}_{suffix}"
        coll.register(ctx, n)
        names[suffix] = n
    return Qc, ACCc, Oc, KNc, names


# ------------------------------------------------------ shared fold math
def attend_page(q: np.ndarray, K: np.ndarray, V: np.ndarray,
                acc: np.ndarray, m: float, l: float, scale: float):
    """One online-softmax fold of `rows` K/V rows into (acc, m, l).
    Pure f32 with a FIXED op order — the single definition both the DAG
    bodies and the numpy reference call, so batched and sequential runs
    are bit-identical."""
    q = q.astype(np.float32, copy=False)
    s = (K.astype(np.float32, copy=False) @ q) * np.float32(scale)
    m_new = np.float32(max(np.float32(m), np.float32(s.max())))
    p = np.exp((s - m_new).astype(np.float32))
    corr = np.float32(np.exp(np.float32(m) - m_new))
    l_new = np.float32(l) * corr + np.float32(p.sum(dtype=np.float32))
    acc_new = acc.astype(np.float32, copy=False) * corr + \
        p @ V.astype(np.float32, copy=False)
    return acc_new.astype(np.float32), m_new, np.float32(l_new)


def finalize_attention(acc: np.ndarray, l: float) -> np.ndarray:
    return (acc / np.float32(max(float(l), 1e-30))).astype(np.float32)


_NEG_BIG = np.float32(-1.0e30)


def reset_acc(tile: np.ndarray, nh: int = 1):
    """Accumulator tile initial value: acc=0, m=-big, l=0 (per head)."""
    dl = tile.shape[1] - 2 * nh
    tile[...] = 0.0
    tile[0, dl:dl + nh] = _NEG_BIG


def attend_heads(q: np.ndarray, K: np.ndarray, V: np.ndarray,
                 at: np.ndarray, scale: float, nh: int,
                 rows: Optional[int] = None):
    """Fold K/V `rows` into the packed `nh`-head accumulator tile IN
    PLACE (layout [acc | m_0.. | l_0..], width dl + 2*nh).  Each head's
    fold is one `attend_page` on CONTIGUOUS per-head operands — slices
    are materialized before BLAS sees them, so the fold's f32 op
    sequence is a function of (head values, rows, dh) only.  nh=1
    degenerates to exactly the single-softmax fold."""
    dl = q.shape[0]
    dh = dl // nh
    if rows is not None:
        K = K[:rows]
        V = V[:rows]
    for h in range(nh):
        sl = slice(h * dh, (h + 1) * dh)
        acc, m, l = attend_page(
            np.ascontiguousarray(q[sl]),
            np.ascontiguousarray(K[:, sl]),
            np.ascontiguousarray(V[:, sl]),
            np.ascontiguousarray(at[0, sl]),
            np.float32(at[0, dl + h]), np.float32(at[0, dl + nh + h]),
            scale)
        at[0, sl] = acc
        at[0, dl + h] = m
        at[0, dl + nh + h] = l


def finalize_heads(at: np.ndarray, nh: int) -> np.ndarray:
    """Per-head finalize of a packed accumulator tile -> (dl,) output."""
    dl = at.shape[1] - 2 * nh
    dh = dl // nh
    out = np.empty(dl, np.float32)
    for h in range(nh):
        out[h * dh:(h + 1) * dh] = finalize_attention(
            np.ascontiguousarray(at[0, h * dh:(h + 1) * dh]),
            np.float32(at[0, dl + nh + h]))
    return out


def fold_heads(qb: torch.Tensor, kb: torch.Tensor, vb: torch.Tensor,
               ab: torch.Tensor, scale: float, nh: int) -> torch.Tensor:
    """The device chore of PATTF/VATF: `attend_heads` on LANE STACKS,
    every head of every lane at once (one product for the scores, one
    for p @ V).  qb [n, 1, dl], kb/vb [n, P, dl] (any lane stride, 0
    included), ab [n, 1, dl + 2*nh] -> the folded accumulators
    [n, 1, dl + 2*nh].  Per head it computes what the reference's
    `_fold_kernel_heads` computes, in f32: on the card the products must
    not round to TF32, so a context that turned TF32 on is refused."""
    if kb.is_cuda and (torch.backends.cuda.matmul.allow_tf32 or
                       torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "fold_heads: TF32 is on for float32 products "
            "(torch.backends.cuda.matmul.allow_tf32); the fold holds the "
            "reference's f32 tolerance only with it off")
    n, P, dl = kb.shape
    dh = dl // nh
    q = qb.reshape(n, nh, dh)
    K = kb.reshape(n, P, nh, dh)
    V = vb.reshape(n, P, nh, dh)
    a = ab.reshape(n, dl + 2 * nh)
    acc = a[:, :dl].reshape(n, nh, dh)
    m = a[:, dl:dl + nh]
    l = a[:, dl + nh:]
    s = torch.einsum("nphd,nhd->nhp", K, q) * scale
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new.unsqueeze(-1))
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(-1)
    acc_new = acc * corr.unsqueeze(-1) + torch.einsum("nhp,nphd->nhd", p, V)
    return torch.cat([acc_new.reshape(n, dl), m_new, l_new],
                     dim=1).unsqueeze(1)


# ----------------------------------------------------------- seq specs
class SeqSpec:
    """One sequence's view of a decode step (or prefill):
      slot    scratch-collection row (Q/ACC/O/KN index)
      pages   page ids, oldest first; the LAST page receives the new row
      fill    decode: row index the new token lands in (valid rows after
              the step = fill + 1); prefill: rows used in the last page
              AFTER the prompt
    """

    __slots__ = ("slot", "pages", "fill")

    def __init__(self, slot: int, pages: Sequence[int], fill: int):
        self.slot = int(slot)
        self.pages = [int(p) for p in pages]
        self.fill = int(fill)
        if not self.pages:
            raise ValueError("a sequence owns at least one page")
        if self.fill < 0:
            raise ValueError(f"negative fill {self.fill}")


def _tables(seqs: Sequence[SeqSpec]):
    slot = [s.slot for s in seqs]
    pages = [list(s.pages) for s in seqs]
    nfro = [len(s.pages) - 1 for s in seqs]
    last = [s.pages[-1] for s in seqs]
    fill = [s.fill for s in seqs]
    return slot, pages, nfro, last, fill


def _attach_fold(dev, fro, tp, d: int, P: int, nh: int, sc: float,
                 batch: bool):
    """Attach the torch fold as the frozen-page class's device chore.
    KV pages stage through the device module like any other tile."""
    aw = d + 2 * nh

    def k_fold(qb, kb, vb, ab):
        return fold_heads(qb, kb, vb, ab, sc, nh)

    dev.attach(fro, tp, kernel=k_fold, reads=["Q", "KP", "VP", "ACC"],
               writes=["ACC"],
               shapes={"Q": (1, d), "KP": (P, d), "VP": (P, d),
                       "ACC": (1, aw)},
               dtype=np.float32, batch=batch)


def _fold_body(d: int, P: int, nh: int, sc: float):
    aw = d + 2 * nh

    def fro_body(v):
        q = v.data("Q", np.float32, (1, d))[0]
        K = v.data("KP", np.float32, (P, d))
        V = v.data("VP", np.float32, (P, d))
        at = v.data("ACC", np.float32, (1, aw))
        attend_heads(q, K, V, at, sc, nh)

    return fro_body


def _last_body(d: int, P: int, nh: int, sc: float, rows_of: Callable):
    aw = d + 2 * nh

    def lst_body(v):
        q = v.data("Q", np.float32, (1, d))[0]
        K = v.data("KP", np.float32, (P, d))
        V = v.data("VP", np.float32, (P, d))
        at = v.data("ACC", np.float32, (1, aw))
        attend_heads(q, K, V, at, sc, nh, rows=rows_of(v["s"]))
        v.data("O", np.float32, (1, d))[0] = finalize_heads(at, nh)

    return lst_body


# ------------------------------------------------------------- builders
def build_paged_decode(ctx, pool: PagePool, seqs: Sequence[SeqSpec],
                       coll_names: Dict[str, str], *, scale: float = None,
                       priority: Optional[int] = None,
                       weight: Optional[int] = None,
                       body_wrap: Optional[Callable] = None,
                       dev=None, nh: int = 1,
                       shard: Optional[dict] = None):
    """One continuous-batching DECODE step over `seqs` as a taskpool
    (created with the given per-pool QoS priority/weight — the tenant
    knobs).  Per sequence: PUPD appends the KN row into the last page,
    PATTF folds each frozen page, PATTL folds the updated last page and
    writes O.  `body_wrap` wraps the PATTL body (fault-injection seam).
    With `dev`, PATTF runs the device fold (`fold_heads`), one launch
    per task as in the reference (batch=False).  `nh` heads, each with
    its own softmax state (packed accumulator)."""
    _no_shard(shard=shard)
    d, P = pool.d, pool.page
    sc = (d ** -0.5) if scale is None else float(scale)
    slot_t, pages_t, nfro_t, last_t, fill_t = _tables(seqs)
    qn, an, on, kn = (coll_names["Q"], coll_names["ACC"], coll_names["O"],
                      coll_names["KN"])

    tp = ctx.taskpool(globals={"NS": len(seqs) - 1}, priority=priority,
                      weight=weight)
    s = L("s")
    j = L("j")
    c_slot = call(lambda locs, g: slot_t[locs[0]], pure=True)
    c_nfro = call(lambda locs, g: nfro_t[locs[0]], pure=True)
    c_last = call(lambda locs, g: last_t[locs[0]], pure=True)
    c_page = call(lambda locs, g: pages_t[locs[0]][locs[1]], pure=True)

    upd = tp.task_class("PUPD")
    upd.param("s", 0, G("NS"))
    upd.flow("KN", "READ", In(Mem(kn, c_slot, 0)))
    upd.flow("KP", "RW", In(Mem(pool.k_name, c_last, 0)),
             Out(Mem(pool.k_name, c_last, 0)),
             Out(Ref("PATTL", s, flow="KP")))
    upd.flow("VP", "RW", In(Mem(pool.v_name, c_last, 0)),
             Out(Mem(pool.v_name, c_last, 0)),
             Out(Ref("PATTL", s, flow="VP")))

    def upd_body(v):
        si = v["s"]
        knrow = v.data("KN", np.float32, (1, 2 * d))
        kp = v.data("KP", np.float32, (P, d))
        vp = v.data("VP", np.float32, (P, d))
        row = fill_t[si]
        kp[row] = knrow[0, :d]
        vp[row] = knrow[0, d:]

    upd.body(upd_body, pure=True)

    fro = tp.task_class("PATTF")
    fro.param("s", 0, G("NS"))
    fro.param("j", 0, c_nfro - 1)  # empty range when the seq has 1 page
    fro.flow("Q", "READ", In(Mem(qn, c_slot, 0)))
    fro.flow("KP", "READ", In(Mem(pool.k_name, c_page, 0)))
    fro.flow("VP", "READ", In(Mem(pool.v_name, c_page, 0)))
    fro.flow("ACC", "RW",
             In(Mem(an, c_slot, 0), guard=(j == 0)),
             In(Ref("PATTF", s, j - 1, flow="ACC")),
             Out(Ref("PATTF", s, j + 1, flow="ACC"),
                 guard=(j < c_nfro - 1)),
             Out(Ref("PATTL", s, flow="ACC"),
                 guard=(j == c_nfro - 1)))
    if dev is not None:
        # device chore FIRST (the runtime takes the first enabled
        # chore): frozen-page folds are shape-uniform (whole pages);
        # PUPD/PATTL stay host (per-task ragged row counts)
        _attach_fold(dev, fro, tp, d, P, nh, sc, batch=False)
    fro.body(_fold_body(d, P, nh, sc), pure=True)

    lst = tp.task_class("PATTL")
    lst.param("s", 0, G("NS"))
    lst.flow("Q", "READ", In(Mem(qn, c_slot, 0)))
    lst.flow("KP", "READ", In(Ref("PUPD", s, flow="KP")))
    lst.flow("VP", "READ", In(Ref("PUPD", s, flow="VP")))
    # chain tail when frozen pages exist; ACC memory slot otherwise —
    # selection rides the producer domain (PATTF(s, -1) does not exist)
    lst.flow("ACC", "RW",
             In(Ref("PATTF", s, c_nfro - 1, flow="ACC")),
             In(Mem(an, c_slot, 0)))
    lst.flow("O", "RW", In(Mem(on, c_slot, 0)), Out(Mem(on, c_slot, 0)))
    # old rows + the row PUPD just wrote
    lst_body = _last_body(d, P, nh, sc, lambda si: fill_t[si] + 1)
    if body_wrap:
        lst.body(body_wrap(lst_body))
    else:
        lst.body(lst_body, pure=True)
    return tp


def build_paged_verify(ctx, pool: PagePool, seqs: Sequence[SeqSpec],
                       coll_names: Dict[str, str], *, scale: float = None,
                       priority: Optional[int] = None,
                       weight: Optional[int] = None,
                       body_wrap: Optional[Callable] = None,
                       dev=None, nh: int = 1,
                       shard: Optional[dict] = None):
    """Speculative-decoding VERIFY WAVE: every page of every sequence is
    already materialized in the KV collections (the shared frozen prefix
    plus host-staged private query-window pages), so the pool is pure
    fold chains — VATF(s, j) folds frozen page j, VATL(s) folds the last
    page to `fill` rows and writes O.  One virtual sequence per (real
    sequence, query position).  With a device attached VATF carries the
    same fold as decode's PATTF, declared BATCHABLE: a wave of ready
    VATF tasks runs as one launch over its lanes.  A verified position's
    host-fold output is BIT-IDENTICAL to the sequential decode step's."""
    _no_shard(shard=shard)
    d, P = pool.d, pool.page
    sc = (d ** -0.5) if scale is None else float(scale)
    slot_t, pages_t, nfro_t, last_t, fill_t = _tables(seqs)
    qn, an, on = coll_names["Q"], coll_names["ACC"], coll_names["O"]

    tp = ctx.taskpool(globals={"NS": len(seqs) - 1}, priority=priority,
                      weight=weight)
    s = L("s")
    j = L("j")
    c_slot = call(lambda locs, g: slot_t[locs[0]], pure=True)
    c_nfro = call(lambda locs, g: nfro_t[locs[0]], pure=True)
    c_last = call(lambda locs, g: last_t[locs[0]], pure=True)
    c_page = call(lambda locs, g: pages_t[locs[0]][locs[1]], pure=True)

    fro = tp.task_class("VATF")
    fro.param("s", 0, G("NS"))
    fro.param("j", 0, c_nfro - 1)
    fro.flow("Q", "READ", In(Mem(qn, c_slot, 0)))
    fro.flow("KP", "READ", In(Mem(pool.k_name, c_page, 0)))
    fro.flow("VP", "READ", In(Mem(pool.v_name, c_page, 0)))
    fro.flow("ACC", "RW",
             In(Mem(an, c_slot, 0), guard=(j == 0)),
             In(Ref("VATF", s, j - 1, flow="ACC")),
             Out(Ref("VATF", s, j + 1, flow="ACC"),
                 guard=(j < c_nfro - 1)),
             Out(Ref("VATL", s, flow="ACC"),
                 guard=(j == c_nfro - 1)))
    if dev is not None:
        _attach_fold(dev, fro, tp, d, P, nh, sc, batch=True)
    fro.body(_fold_body(d, P, nh, sc), pure=True)

    lst = tp.task_class("VATL")
    lst.param("s", 0, G("NS"))
    lst.flow("Q", "READ", In(Mem(qn, c_slot, 0)))
    lst.flow("KP", "READ", In(Mem(pool.k_name, c_last, 0)))
    lst.flow("VP", "READ", In(Mem(pool.v_name, c_last, 0)))
    lst.flow("ACC", "RW",
             In(Ref("VATF", s, c_nfro - 1, flow="ACC")),
             In(Mem(an, c_slot, 0)))
    lst.flow("O", "RW", In(Mem(on, c_slot, 0)), Out(Mem(on, c_slot, 0)))
    lst_body = _last_body(d, P, nh, sc, lambda si: fill_t[si])
    if body_wrap:
        lst.body(body_wrap(lst_body))
    else:
        lst.body(lst_body, pure=True)
    return tp


def build_paged_prefill(ctx, pool: PagePool, seqs: Sequence[SeqSpec],
                        coll_names: Dict[str, str], prompt_name: str,
                        prompt_tiles: Sequence[Sequence[int]], *,
                        scale: float = None,
                        priority: Optional[int] = None,
                        weight: Optional[int] = None,
                        body_wrap: Optional[Callable] = None,
                        warm: Optional[Sequence[int]] = None,
                        nh: int = 1, shard: Optional[dict] = None):
    """PREFILL as a taskpool: PFILL(s, j) writes page j of sequence s
    from the staged prompt collection (`prompt_name`, one (page, 2d)
    k|v tile per written page, indices in `prompt_tiles[s][j]`), then
    the PATTF/PATTL fold chain computes attention for the LAST prompt
    position over all written rows.  `seqs[i].fill` is the row count
    used in the last page (1..page).

    `warm[i]` (prefix cache) marks the first `warm[i]` pages of sequence
    i as ALREADY MATERIALIZED shared frozen pages: PFILL's domain starts
    at the cold tail, and the fold chain reads warm pages straight from
    the KV collections (PFILL(s, j<warm) does not exist).  A fully-warm
    sequence prefills ZERO pages and still folds its whole cache."""
    _no_shard(shard=shard)
    d, P = pool.d, pool.page
    sc = (d ** -0.5) if scale is None else float(scale)
    slot_t, pages_t, nfro_t, last_t, fill_t = _tables(seqs)
    ptiles = [list(row) for row in prompt_tiles]
    warm_t = [0] * len(seqs) if warm is None else [int(w) for w in warm]
    if len(warm_t) != len(seqs):
        raise ValueError("warm needs one entry per sequence")
    qn, an, on = coll_names["Q"], coll_names["ACC"], coll_names["O"]

    tp = ctx.taskpool(globals={"NS": len(seqs) - 1}, priority=priority,
                      weight=weight)
    s = L("s")
    j = L("j")
    c_slot = call(lambda locs, g: slot_t[locs[0]], pure=True)
    c_nfro = call(lambda locs, g: nfro_t[locs[0]], pure=True)
    c_warm = call(lambda locs, g: warm_t[locs[0]], pure=True)
    c_last = call(lambda locs, g: last_t[locs[0]], pure=True)
    c_page = call(lambda locs, g: pages_t[locs[0]][locs[1]], pure=True)
    c_ptile = call(lambda locs, g: ptiles[locs[0]][locs[1]], pure=True)

    fil = tp.task_class("PFILL")
    fil.param("s", 0, G("NS"))
    fil.param("j", c_warm, c_nfro)  # cold tail: warm..npages-1
    fil.flow("SRC", "READ", In(Mem(prompt_name, c_ptile, 0)))
    fil.flow("KP", "RW", In(Mem(pool.k_name, c_page, 0)),
             Out(Mem(pool.k_name, c_page, 0)),
             Out(Ref("PATTF", s, j, flow="KP"), guard=(j < c_nfro)),
             Out(Ref("PATTL", s, flow="KP"), guard=(j == c_nfro)))
    fil.flow("VP", "RW", In(Mem(pool.v_name, c_page, 0)),
             Out(Mem(pool.v_name, c_page, 0)),
             Out(Ref("PATTF", s, j, flow="VP"), guard=(j < c_nfro)),
             Out(Ref("PATTL", s, flow="VP"), guard=(j == c_nfro)))

    def fil_body(v):
        si = v["s"]
        rows = P if v["j"] < nfro_t[si] else fill_t[si]
        src = v.data("SRC", np.float32, (P, 2 * d))
        kp = v.data("KP", np.float32, (P, d))
        vp = v.data("VP", np.float32, (P, d))
        kp[:rows] = src[:rows, :d]
        vp[:rows] = src[:rows, d:]

    fil.body(fil_body, pure=True)

    fro = tp.task_class("PATTF")
    fro.param("s", 0, G("NS"))
    fro.param("j", 0, c_nfro - 1)
    fro.flow("Q", "READ", In(Mem(qn, c_slot, 0)))
    # cold pages arrive from PFILL through the DAG; warm (shared frozen)
    # pages fall back to the KV collection datum
    fro.flow("KP", "READ", In(Ref("PFILL", s, j, flow="KP")),
             In(Mem(pool.k_name, c_page, 0)))
    fro.flow("VP", "READ", In(Ref("PFILL", s, j, flow="VP")),
             In(Mem(pool.v_name, c_page, 0)))
    fro.flow("ACC", "RW",
             In(Mem(an, c_slot, 0), guard=(j == 0)),
             In(Ref("PATTF", s, j - 1, flow="ACC")),
             Out(Ref("PATTF", s, j + 1, flow="ACC"),
                 guard=(j < c_nfro - 1)),
             Out(Ref("PATTL", s, flow="ACC"),
                 guard=(j == c_nfro - 1)))
    fro.body(_fold_body(d, P, nh, sc), pure=True)

    lst = tp.task_class("PATTL")
    lst.param("s", 0, G("NS"))
    lst.flow("Q", "READ", In(Mem(qn, c_slot, 0)))
    # a fully-warm sequence's LAST page is shared too: Mem fallback
    lst.flow("KP", "READ", In(Ref("PFILL", s, c_nfro, flow="KP")),
             In(Mem(pool.k_name, c_last, 0)))
    lst.flow("VP", "READ", In(Ref("PFILL", s, c_nfro, flow="VP")),
             In(Mem(pool.v_name, c_last, 0)))
    lst.flow("ACC", "RW",
             In(Ref("PATTF", s, c_nfro - 1, flow="ACC")),
             In(Mem(an, c_slot, 0)))
    lst.flow("O", "RW", In(Mem(on, c_slot, 0)), Out(Mem(on, c_slot, 0)))
    lst_body = _last_body(d, P, nh, sc, lambda si: fill_t[si])
    if body_wrap:
        lst.body(body_wrap(lst_body))
    else:
        lst.body(lst_body, pure=True)
    return tp

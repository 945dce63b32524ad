"""Benchmark helpers: on-device data generation and residual checks.

DPLASMA-style benchmarking generates the matrix in place (dplrnt) and
verifies with a residual — no host round trips.  These helpers do the
same on the card: tiles are generated on the device straight into the
device copy cache, and correctness is a device-side
||L L^T - A||_F / ||A||_F.  Port of parsec_tpu/device/bench_utils.py.

Generated tiles are installed as CLEAN mirrors: their host copies stay
as they were (zeros), so the device's cache budget must hold the
generated stack until every tile of it has been consumed — an evicted
clean row would be staged again from the host.  Size `cache_bytes`
from the card's memory, as the smoke does.

Everything here runs on the device's exec stream, the one its manager
launches on, so generation is ordered before the first chore and a
residual after the last.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _native as N
from .cuda import CudaDevice, local_tile_index


def _spd_blocks(seed: int, nt: int, nb: int, Nn: int, device):
    """Every nb x nb block (m, n), m, n < nt, of the symmetric diagonally
    dominant (hence SPD) test matrix, as (m, n, block): one draw per
    unordered pair (min, max) from a generator seeded from (seed, lo,
    hi), the draw below the diagonal and its transpose above, the
    symmetric part plus 2N on the diagonal.  The single definition the
    tiled and the panel generators both consume — their matrices are
    byte-identical block for block.  (Its bits are not jax.random's.)"""
    eye = torch.eye(nb, dtype=torch.float32, device=device)
    for hi in range(nt):
        for lo in range(hi + 1):
            state = np.random.SeedSequence([seed, lo, hi]).generate_state(
                1, np.uint64)[0]
            g = torch.Generator(device=device)
            g.manual_seed(int(state) & ((1 << 63) - 1))
            t = torch.randn((nb, nb), generator=g, dtype=torch.float32,
                            device=device)
            if lo == hi:
                yield lo, lo, (t + t.mT) * 0.5 + (2.0 * Nn) * eye
            else:
                yield hi, lo, t
                yield lo, hi, t.mT


def generate_spd_on_device(dev: CudaDevice, coll, seed: int = 0):
    """Generate the SPD test matrix on the device and install its tiles
    in the device copy cache.  Returns the stacked (ntiles, nb, nb)
    tensor (local tiles in row-major order)."""
    nb = coll.mb
    tiles = local_tile_index(coll)
    row = {mn: i for i, mn in enumerate(tiles)}
    with dev._on_stream():
        stacked = torch.empty((len(tiles), nb, nb), dtype=torch.float32,
                              device=dev.device)
        for m, n, blk in _spd_blocks(seed, coll.mt, nb, coll.M,
                                     dev.device):
            i = row.get((m, n))
            if i is not None:
                stacked[i] = blk
    install_device_tiles(dev, coll, stacked)
    return stacked


def generate_spd_panels_on_device(dev: CudaDevice, coll, seed: int = 0):
    """Panel-collection variant of generate_spd_on_device: `coll` is one
    block row of N x nb column panels (TwoDimBlockCyclic(N, N, N, nb)).
    Generates the SAME matrix the tiled generator would, as stacked
    (nt, N, nb) panels (this rank's), and installs them in the device
    cache."""
    nb, nt = coll.nb, coll.nt
    assert coll.mt == 1 and coll.mb == coll.M
    panels = [n for _, n in local_tile_index(coll)]
    row = {j: i for i, j in enumerate(panels)}
    with dev._on_stream():
        stacked = torch.empty((len(panels), coll.M, nb),
                              dtype=torch.float32, device=dev.device)
        for m, n, blk in _spd_blocks(seed, nt, nb, coll.M, dev.device):
            i = row.get(n)
            if i is not None:
                stacked[i, m * nb:(m + 1) * nb] = blk
    install_device_tiles(dev, coll, stacked)
    return stacked


def _tile_key(dev: CudaDevice, coll, *idx):
    cptr = N.lib.ptc_data_host_copy(coll.data_of(*idx)._ptr)
    return dev._copy_uid(cptr), N.lib.ptc_copy_version(cptr)


def install_device_tiles(dev: CudaDevice, coll, stacked: torch.Tensor):
    """Install stacked[i] as the clean device mirror of local tile i
    (row-major local order): each mirror is a row of the stack, so a
    launch whose lanes read consecutive tiles takes a slice of it."""
    nbytes = coll.mb * coll.nb * coll.dtype.itemsize
    for i, (m, n) in enumerate(local_tile_index(coll)):
        uid, ver = _tile_key(dev, coll, m, n)
        dev._cache_put(uid, ver, stacked[i], nbytes, stack=stacked, idx=i)


def install_device_segments(dev: CudaDevice, vcoll, stacked: torch.Tensor):
    """1-D collection variant of install_device_tiles: stacked[i] becomes
    the clean device mirror of this rank's i-th local segment (ascending
    key order).  Pre-stages index collections, so each wave's index
    lanes are a row slice of one stack."""
    nbytes = vcoll.nb * vcoll.dtype.itemsize
    local = [k for k in range(vcoll.nt) if vcoll.rank_of(k) == vcoll.myrank]
    for i, k in enumerate(local):
        uid, ver = _tile_key(dev, vcoll, k)
        dev._cache_put(uid, ver, stacked[i], nbytes, stack=stacked, idx=i)


def device_tiles(dev: CudaDevice, coll):
    """(m, n), current device value of each local tile, in row-major
    order (a tile with no current mirror is staged from its host copy).
    Read it on the device's exec stream."""
    shape = (coll.mb, coll.nb)
    for m, n in local_tile_index(coll):
        uid, ver = _tile_key(dev, coll, m, n)
        t = dev._cache_get_typed(uid, ver, coll.dtype, shape)
        yield (m, n), (t if t is not None
                       else dev._h2d_ahead(coll.tile(m, n))[0])


def gather_device_tiles(dev: CudaDevice, coll) -> torch.Tensor:
    """The current device values of all local tiles as one stacked
    tensor."""
    with dev._on_stream():
        return torch.stack([t for _, t in device_tiles(dev, coll)])


def wait_device_tiles(dev: CudaDevice, coll) -> None:
    """Block until every local tile's current device value is final:
    every chore runs on the device's exec stream, in order, so that is
    the stream's end."""
    if dev._stream is not None:
        dev._stream.synchronize()


def assemble_dense(stacked, mt, nt, nb, mb=None):
    """(mt*nt, mb, nb) row-major tiles -> (mt*mb, nt*nb) dense, on the
    tiles' device.  mb defaults to nb (square tiles); panel collections
    pass mb=M."""
    mb = nb if mb is None else mb
    return stacked.reshape(mt, nt, mb, nb).permute(0, 2, 1, 3).reshape(
        mt * mb, nt * nb)


def _dense_from_mirrors(dev: CudaDevice, coll) -> torch.Tensor:
    """The dense matrix of the local tiles' current device values, built
    a block row at a time (no stacked copy of every tile first)."""
    rows = {}
    for (m, _), t in device_tiles(dev, coll):
        rows.setdefault(m, []).append(t)
    blocks = [torch.cat(r, dim=1) for _, r in sorted(rows.items())]
    return blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=0)


def potrf_residual(dev: CudaDevice, coll, a_stacked: torch.Tensor,
                   block_rows: int = 2048) -> float:
    """Device-side ||tril(L) tril(L)^T - A||_F / ||A||_F (one scalar to
    the host), L L^T formed and both norms summed (in float64) a block
    of rows at a time: the check holds two dense float32 matrices on the
    device besides the cache, not seven."""
    from ..algos._util import refuse_tf32
    mb, nb = coll.mb, coll.nb
    with dev._on_stream(), torch.no_grad():
        L = _dense_from_mirrors(dev, coll).tril_()
        A = assemble_dense(a_stacked, coll.mt, coll.nt, nb, mb)
        refuse_tf32(L, "potrf_residual")
        num = torch.zeros((), dtype=torch.float64, device=L.device)
        den = torch.zeros_like(num)
        for r0 in range(0, L.shape[0], block_rows):
            a = A[r0:r0 + block_rows]
            num += torch.linalg.vector_norm(
                L[r0:r0 + block_rows] @ L.mT - a, dtype=torch.float64) ** 2
            den += torch.linalg.vector_norm(a, dtype=torch.float64) ** 2
        return float((num / den).sqrt())

"""Handing a dense matrix to the program's tiles and reading it back.

The drivers' shared steps, through the port's device-resident entry
(`device.bench_utils`): a matrix is installed as the clean device
mirrors of a collection's tiles, rows of one stacked tensor, as a user
whose data is already resident on the card would hold it.
"""
from __future__ import annotations

import torch

from parsec_tpu_torch.device.bench_utils import (device_tiles,
                                                 install_device_tiles,
                                                 wait_device_tiles)
from parsec_tpu_torch.device.cuda import local_tile_index


def _sync(dev) -> None:
    if dev.device.type == "cuda":
        torch.cuda.synchronize(dev.device)


def stack(dense: torch.Tensor, coll) -> torch.Tensor:
    """The local tiles of `dense` in the collection's row-major local
    order, as one contiguous [tiles, mb, nb] tensor."""
    mb, nb = coll.mb, coll.nb
    return torch.stack([dense[m * mb:(m + 1) * mb, n * nb:(n + 1) * nb]
                        for m, n in local_tile_index(coll)])


def install(dev, coll, pristine: torch.Tensor) -> None:
    """Install a fresh copy of `pristine` as the collection's device
    tiles; the copy has landed when this returns."""
    work = pristine.clone()
    _sync(dev)
    install_device_tiles(dev, coll, work)


def dense(dev, coll) -> torch.Tensor:
    """A copy of the collection's current device tiles as one dense
    float32 matrix."""
    wait_device_tiles(dev, coll)
    mb, nb = coll.mb, coll.nb
    out = torch.empty((coll.mt * mb, coll.nt * nb), dtype=torch.float32,
                      device=dev.device)
    for (m, n), t in device_tiles(dev, coll):
        out[m * mb:(m + 1) * mb, n * nb:(n + 1) * nb] = t
    _sync(dev)
    return out

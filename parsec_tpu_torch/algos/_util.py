"""Shared helpers for the algorithm taskpools and their device chores."""
from __future__ import annotations

import torch


def as_device_list(dev):
    """Normalize the dev argument (None | CudaDevice | list/tuple of
    them) to a list."""
    if dev is None:
        return []
    if isinstance(dev, (list, tuple)):
        return list(dev)
    return [dev]


def refuse_tf32(t: torch.Tensor, chore: str) -> None:
    """Raise when a chore would run its float32 products in TF32 on the
    card: the dense-LA chores hold the reference's float32 tolerances,
    which a TF32 product (about three decimal digits) does not."""
    if t.is_cuda and (torch.backends.cuda.matmul.allow_tf32 or
                      torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            f"{chore}: TF32 is on for float32 products "
            "(torch.backends.cuda.matmul.allow_tf32 or "
            "torch.set_float32_matmul_precision); the dense-LA chores hold "
            "the reference's float32 tolerance only with it off")


def lane_rows(p: torch.Tensor, ks: torch.Tensor, nb: int) -> torch.Tensor:
    """Row indices [lanes, nb] of block row ks[lane] of each lane's
    panel, built on the device (ks is a [lanes, 1] int32 index flow; a
    host read of it would sync with the stream at every launch)."""
    return ks[:, :1].long() * nb + torch.arange(nb, device=p.device)


def take_rows(p: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """p[lane, rows[lane], :] for every lane: [lanes, nb, width] (a new
    tensor; p may be a lane-stride-0 view)."""
    lanes = torch.arange(rows.shape[0], device=p.device)[:, None]
    return p[lanes, rows]


def put_rows(x: torch.Tensor, rows: torch.Tensor,
             block: torch.Tensor) -> torch.Tensor:
    """x[lane, rows[lane], :] = block[lane], in place on x, which must be
    a tensor the chore made itself (never an input lane stack)."""
    lanes = torch.arange(rows.shape[0], device=x.device)[:, None]
    x[lanes, rows] = block
    return x


def rows_from(x: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """[lanes, height, 1] mask: row index >= start[lane] (start [lanes])."""
    r = torch.arange(x.shape[1], device=x.device)
    return r[None, :, None] >= start[:, None, None]

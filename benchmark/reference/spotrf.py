"""spotrf (DPLASMA testing_spotrf, lower): inputs, flops and the plain
reference.

Plain PyTorch and NumPy only: nothing of the program, nothing of JAX.

- `inputs`: the test matrix of DPLASMA's `dplasma_splghe` with the bump
  testing_spotrf gives it: entries uniform in (-0.5, 0.5], the lower
  triangle mirrored into the upper, plus N on the diagonal.  Made on the
  device from the seed in one draw (`plghe`).
- `flops`: DPLASMA's count for potrf, N^3/3 + N^2/2 + N/6, whatever
  computes it.
- `check`: the float64 Cholesky factor of the same matrix, against which
  the factor a solve left in the device tiles is judged.
- `control`: the factor in the precision below the configuration's,
  computed as the program computes it (each panel solved by a product
  with the inverse of its diagonal block, then the trailing update) with
  every product in TF32, for the limit's upper reading.

The number compared is the relative Frobenius error of the strictly
lower triangle.  The matrix is diagonally dominant, so the diagonal
holds nearly all of L's norm and a whole-matrix error or residual would
hide what rounding does to the off-diagonal entries.
"""
from __future__ import annotations

import torch

from harness.lowp import mm_tf32


def _seed(seed: int) -> int:
    return int(seed) & ((1 << 63) - 1)


def plghe(seed: int, n: int, nb: int, device) -> torch.Tensor:
    """The N x N float32 test matrix of `dplasma_splghe(N, ...)`: one
    uniform draw from a generator on `device` seeded by the seed, made
    symmetric from its lower triangle a block column of `nb` at a time,
    plus N on the diagonal."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    a = torch.rand((n, n), generator=g, dtype=torch.float32, device=device)
    a.neg_().add_(0.5)
    for k in range(0, n, nb):
        e = min(k + nb, n)
        d = a[k:e, k:e]
        d.copy_(d.tril() + d.tril(-1).mT)
        if e < n:
            a[k:e, e:] = a[e:, k:e].mT
    a.diagonal().add_(float(n))
    return a


def inputs(seed, traffic, config, device) -> dict:
    """{"A": the dense N x N float32 test matrix on `device`}."""
    return {"A": plghe(_seed(seed), int(traffic["N"]), int(config["NB"]),
                       device)}


def flops(traffic, config) -> float:
    n = float(traffic["N"])
    return n ** 3 / 3.0 + n ** 2 / 2.0 + n / 6.0


def offdiag_error(l: torch.Tensor, ref: torch.Tensor,
                  rows: int = 4096) -> float:
    """||tril(l, -1) - tril(ref, -1)||_F / ||tril(ref, -1)||_F in
    float64, a block of rows at a time."""
    num = torch.zeros((), dtype=torch.float64, device=ref.device)
    den = torch.zeros_like(num)
    for r0 in range(0, ref.shape[0], rows):
        want = torch.tril(ref[r0:r0 + rows], diagonal=r0 - 1)
        got = torch.tril(l[r0:r0 + rows].to(ref.device, torch.float64),
                         diagonal=r0 - 1)
        num += torch.sum((got - want) ** 2)
        den += torch.sum(want ** 2)
    return float((num / den).sqrt())


def _factor64(seed, traffic, config, device) -> torch.Tensor:
    a = inputs(seed, traffic, config, device)["A"].double()
    return torch.linalg.cholesky(a)


def check(seed, traffic, config, outputs, device) -> dict:
    """The worst error over the sampled solves' factors."""
    ref = _factor64(seed, traffic, config, device)
    return {"l_offdiag_err": max(offdiag_error(o["A"], ref)
                                 for o in outputs)}


def cholesky_tf32(a: torch.Tensor, nb: int) -> torch.Tensor:
    """Right-looking blocked Cholesky in float32 as the program computes
    it, each panel solved by a product with the inverse of its diagonal
    block, with every product in TF32: the step a lower-precision port
    would take.  The diagonal blocks' factors and inverses stay float32."""
    n = a.shape[0]
    l = a.clone()
    for k in range(0, n, nb):
        e = k + nb
        lkk = torch.linalg.cholesky(l[k:e, k:e])
        l[k:e, k:e] = lkk
        if e < n:
            eye = torch.eye(e - k, dtype=l.dtype, device=l.device)
            inv = torch.linalg.solve_triangular(lkk, eye, upper=False)
            l[e:, k:e] = mm_tf32(l[e:, k:e], inv.mT)
            p = l[e:, k:e]
            l[e:, e:] -= mm_tf32(p, p.mT)
    return l.tril_()


def control(seed, traffic, config, device) -> dict:
    """The compared number for the TF32 factor of the same matrix."""
    a = inputs(seed, traffic, config, device)["A"]
    low = cholesky_tf32(a, int(config["NB"]))
    del a
    return {"l_offdiag_err": offdiag_error(
        low, _factor64(seed, traffic, config, device))}

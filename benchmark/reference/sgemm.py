"""sgemm (DPLASMA testing_sgemm, NN, C = A B + C with C = 0): inputs,
flops and the plain reference.

Plain PyTorch only: nothing of the program, nothing of JAX.

- `inputs`: A and B of standard normal entries from one generator on
  the device seeded by the seed (A drawn first).
- `flops`: 2 M N K with M = N = K.
- `check`: the float64 product, against which the C a solve left in the
  device tiles is judged: the relative Frobenius error of C.
- `control`: the same product with TF32 products, for the limit's upper
  reading.
"""
from __future__ import annotations

import torch

from harness.lowp import mm_tf32


def _seed(seed: int) -> int:
    return int(seed) & ((1 << 63) - 1)


def inputs(seed, traffic, config, device) -> dict:
    n = int(traffic["N"])
    g = torch.Generator(device=device)
    g.manual_seed(_seed(seed))
    a = torch.randn((n, n), generator=g, dtype=torch.float32, device=device)
    b = torch.randn((n, n), generator=g, dtype=torch.float32, device=device)
    return {"A": a, "B": b}


def flops(traffic, config) -> float:
    return 2.0 * float(traffic["N"]) ** 3


def rel_error(c: torch.Tensor, ref: torch.Tensor) -> float:
    """||c - ref||_F / ||ref||_F in float64."""
    d = c.to(ref.device, torch.float64) - ref
    return float(torch.linalg.vector_norm(d) / torch.linalg.vector_norm(ref))


def _product64(seed, traffic, config, device) -> torch.Tensor:
    x = inputs(seed, traffic, config, device)
    return x["A"].double() @ x["B"].double()


def check(seed, traffic, config, outputs, device) -> dict:
    """The worst error over the sampled solves' C."""
    ref = _product64(seed, traffic, config, device)
    return {"c_err": max(rel_error(o["C"], ref) for o in outputs)}


def control(seed, traffic, config, device) -> dict:
    x = inputs(seed, traffic, config, device)
    low = mm_tf32(x["A"], x["B"])
    return {"c_err": rel_error(low, _product64(seed, traffic, config,
                                                device))}

"""The precision below float32 for the controls: TF32 products.

On the card this is the card's own TF32 mode; on the host (the tests)
the same rounding of the operands, with float32 accumulation.
"""
from __future__ import annotations

import torch


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32: 10 explicit mantissa bits, to nearest."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with TF32 products."""
    if a.is_cuda:
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return a @ b
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
    return to_tf32(a) @ to_tf32(b)
